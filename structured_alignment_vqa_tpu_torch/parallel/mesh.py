"""The layout of a data-parallel run (counterpart of the TPU package's
``parallel/mesh.py``).

The TPU package lays a ``jax.sharding.Mesh`` with axes (data, seq, model)
over its devices. Here one process drives one device, and the processes
form a ``torch.distributed`` group: :class:`Mesh` records that group's
sizes, this process's place in it and its device. Only the data axis is
ported: ``seq_parallel > 1`` is ring and Ulysses attention (ROADMAP Queue 1
item 16) and ``model_parallel > 1`` the vocab-split tables and the
column/row-split FFN and heads (item 15b); both raise
``NotImplementedError``.

:func:`init_distributed` forms the group over TCP from the training CLI's
flags (``--coordinator host:port --num_processes N --process_id i``), or
at a port of this host that :func:`free_ports` finds, for the ranks of one
host alone: NCCL between cards, gloo on the CPU. Host-side flags and
counts travel on a gloo group beside it (``Mesh.cpu_group``), so that they
need no copy to the device.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import warnings
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from structured_alignment_vqa_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of a data-parallel run.

    ``data`` is the number of ranks in the group (``seq`` and ``model`` are
    1); ``rank`` the global rank; ``local_rank`` and ``local_world`` its
    place among the ranks of its host; ``device`` the device it drives.
    ``group`` carries the device tensors (gradients, scores, metrics),
    ``cpu_group`` the host's flags and counts; both are None in a mesh of
    one process without a group (:func:`single_mesh`).
    """

    data: int
    rank: int
    local_rank: int
    local_world: int
    device: torch.device
    group: Any = None
    cpu_group: Any = None
    seq: int = 1
    model: int = 1

    @property
    def world(self) -> int:
        return self.data * self.seq * self.model

    @property
    def distributed(self) -> bool:
        """More than one rank: the cross-sample operations reduce over the
        group. With one rank they are the single-device code."""
        return self.world > 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq, MODEL_AXIS: self.model}


def check_axes(model_parallel: int = 1, seq_parallel: int = 1) -> None:
    if seq_parallel > 1:
        raise NotImplementedError(
            "seq_parallel > 1 (ring and Ulysses sequence parallelism) is not ported yet "
            "(ROADMAP Queue 1 item 16)")
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1 (the model axis: vocab-split tables, column/row-split FFN "
            "and heads) is not ported yet (ROADMAP Queue 1 item 15b)")


def single_mesh(device=None) -> Mesh:
    """A mesh of this process alone, with no group."""
    return Mesh(data=1, rank=0, local_rank=0, local_world=1, device=resolve_device(device))


def fitting_data_size(n_devices: int, batch_size: int, model_parallel: int = 1,
                      seq_parallel: int = 1) -> int:
    """The TPU package's ``fitting_mesh`` rule: the largest data-axis size
    that divides ``batch_size``, out of ``n_devices // (model_parallel *
    seq_parallel)``; warns when devices stay idle. A small debug batch must
    not force an 8-way split of a batch of 4."""
    inner = model_parallel * seq_parallel
    data_ax = max(n_devices // inner, 1)
    while data_ax > 1 and batch_size % data_ax:
        data_ax -= 1
    used = data_ax * inner
    if used < n_devices:
        warnings.warn(
            f"fitting_mesh: batch_size={batch_size} with model_parallel={model_parallel}, "
            f"seq_parallel={seq_parallel} uses only {used} of {n_devices} devices "
            f"({n_devices - used} idle). Pick a batch size divisible by "
            f"{n_devices // inner} to use every device.",
            stacklevel=2,
        )
    return data_ax


def free_ports(n: int = 1) -> List[int]:
    """``n`` distinct free local ports (the sockets are held open together,
    so no two of them can be the same)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None, device=None,
                     local_rank: int = 0, local_world: int = 1) -> Mesh:
    """Join the group of ``num_processes`` ranks at ``coordinator``
    (``host:port`` of rank 0, which listens there) as rank ``process_id``;
    returns this rank's :class:`Mesh`.

    ``device=None`` is ``cuda:<local_rank>`` (raising without a card);
    ``backend=None`` is NCCL on a card and gloo on the CPU. Several ranks
    on one card need ``backend="gloo"`` (NCCL refuses them). A group that
    does not form within ``DEFAULT_TIMEOUT_S`` raises; nothing falls back
    to a single process.
    """
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    cpu_group = (dist.group.WORLD if backend == "gloo"
                 else dist.new_group(backend="gloo", timeout=timeout))
    return Mesh(data=num_processes, rank=process_id, local_rank=local_rank,
                local_world=local_world, device=device, group=dist.group.WORLD,
                cpu_group=cpu_group)


def shutdown(mesh: Optional[Mesh]) -> None:
    """Leave the group ``mesh`` was formed over, if any."""
    if mesh is not None and mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()
