"""The ambient mesh (counterpart of the TPU package's ``parallel/context.py``).

The model's cross-sample operations (the CE denominator, the MIL-NCE means
and the relation branch's joint softmax, the MCB norm over the batch axis)
find the mesh here, so that no ``forward`` signature carries it, as the
TPU package's ring attention finds its mesh. The training and eval steps
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
    """The ambient mesh when it has more than one rank, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.distributed else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
