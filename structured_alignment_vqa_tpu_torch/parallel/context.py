"""The ambient mesh (counterpart of the TPU package's ``parallel/context.py``).

The model's cross-sample operations (the CE denominator, the MIL-NCE means
and the relation branch's joint softmax, the MCB norm over the batch axis)
find the mesh here, so that no ``forward`` signature carries it, as the
TPU package's ring attention finds its mesh; so do the port's ring and
Ulysses attention (``ops/attention.py``). The training and eval steps
wrap their work in :func:`use_mesh`; with no mesh, or a mesh of one rank,
every operation is the single-device code.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from structured_alignment_vqa_tpu_torch.parallel.mesh import Mesh

_state = threading.local()


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def distributed_mesh() -> Optional[Mesh]:
    """The ambient mesh's data column (``Mesh.data_view``) when the global
    batch is split over more than one rank, else None: the ranks of a seq
    row hold the same samples, so the cross-sample operations reduce over
    the data column alone."""
    mesh = current_mesh()
    if mesh is None:
        return None
    view = mesh.data_view()
    return view if view.distributed else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
