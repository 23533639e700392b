"""The layout of a data-, sequence- and model-parallel run (counterpart of
the TPU package's ``parallel/mesh.py``).

The TPU package lays a ``jax.sharding.Mesh`` with axes (data, seq, model)
over its devices. Here one process drives one device, and the processes
form a ``torch.distributed`` group: :class:`Mesh` records that group's
sizes, this process's place in it and its device. The ranks form a (data,
seq, model) grid, rank r at data ``r // (seq * model)``, seq ``(r //
model) % seq`` and model ``r % model`` (the TPU package's reshape, model
innermost). The ranks of one seq row hold the same samples and split each
encoder sequence between them (ring and Ulysses attention,
``ops/ring_attention.py``, ``ops/ulysses_attention.py``); the ranks of one
model row hold the same samples and each holds its shard of the split
parameters (``parallel/sharding.py:param_pspec``); each data column holds
one rank of every (seq, model) cell, and the global batch's reductions run
over it (:meth:`Mesh.data_view`).

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
    """One process's view of a data-, sequence- and model-parallel run.

    ``data``, ``seq`` and ``model`` are the axes' sizes; ``rank`` the
    global rank; ``local_rank`` and ``local_world`` its place among the
    ranks of its host; ``device`` the device it drives. ``group`` carries
    the device tensors of every rank (the state's broadcast), ``cpu_group``
    the host's flags and counts; both are None in a mesh of one process
    without a group (:func:`single_mesh`). With ``seq > 1``, ``seq_group``
    holds this rank's seq row; with ``model > 1``, ``model_group`` (and
    ``model_cpu_group``) its model row; with either, ``data_group`` (and
    ``data_cpu_group``) its data column.
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
    seq_group: Any = None
    data_group: Any = None
    data_cpu_group: Any = None
    model_group: Any = None
    model_cpu_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.seq * self.model

    @property
    def distributed(self) -> bool:
        """More than one rank. With one rank every operation is the
        single-device code."""
        return self.world > 1

    @property
    def data_index(self) -> int:
        return self.rank // (self.seq * self.model)

    @property
    def seq_index(self) -> int:
        return (self.rank // self.model) % self.seq

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def seq_peer(self, offset: int) -> int:
        """The global rank ``offset`` places along this rank's seq row."""
        s = (self.seq_index + offset) % self.seq
        return (self.data_index * self.seq + s) * self.model + self.model_index

    def data_view(self) -> "Mesh":
        """The mesh of this rank's data column: the ranks that hold the
        global batch between them, one rank of each (seq, model) cell, over
        which the cross-sample operations and the gradients are reduced
        (the ranks of a seq or model row hold the same samples; a sum over
        all ranks would count each sample ``seq * model`` times). With
        ``seq == model == 1`` the mesh itself."""
        if self.seq == 1 and self.model == 1:
            return self
        return dataclasses.replace(self, rank=self.data_index, seq=1, model=1,
                                   group=self.data_group, cpu_group=self.data_cpu_group,
                                   seq_group=None, data_group=None, data_cpu_group=None,
                                   model_group=None, model_cpu_group=None)

    def model_view(self) -> "Mesh":
        """The mesh of this rank's model row (its ``group`` the model row's):
        the ranks that hold one sample between them, each a shard of the
        split parameters."""
        return dataclasses.replace(self, rank=self.model_index, data=self.model, seq=1, model=1,
                                   group=self.model_group, cpu_group=self.model_cpu_group,
                                   seq_group=None, data_group=None, data_cpu_group=None,
                                   model_group=None, model_cpu_group=None)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq, MODEL_AXIS: self.model}


def check_axes(model_parallel: int = 1, seq_parallel: int = 1, hidden_size: int = 0,
               num_heads: int = 1) -> None:
    """Raise ``ValueError`` for axis sizes below 1, or for a ``hidden_size``
    that ``num_heads`` does not divide. Every ``model_parallel`` is covered:
    where it splits the attention projections' columns but not the heads, a
    head spans ranks and each rank computes the heads its columns overlap
    (``ops/attention.py``), as the TPU package's GSPMD reshards them."""
    if model_parallel < 1 or seq_parallel < 1:
        raise ValueError(f"axis sizes must be >= 1: model {model_parallel}, seq {seq_parallel}")
    if hidden_size and hidden_size % num_heads:
        raise ValueError(f"hidden_size={hidden_size} is not divisible by num_heads={num_heads}")


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
                     local_rank: int = 0, local_world: int = 1,
                     seq_parallel: int = 1, model_parallel: int = 1) -> Mesh:
    """Join the group of ``num_processes`` ranks at ``coordinator``
    (``host:port`` of rank 0, which listens there) as rank ``process_id``;
    returns this rank's :class:`Mesh`, a (``num_processes // (seq_parallel
    * model_parallel)``, ``seq_parallel``, ``model_parallel``) grid of
    (data, seq, model) with a subgroup for each seq row, model row and
    data column (:func:`grid`).

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
    mesh = Mesh(data=num_processes, rank=process_id, local_rank=local_rank,
                local_world=local_world, device=device, group=dist.group.WORLD,
                cpu_group=cpu_group)
    if seq_parallel > 1 or model_parallel > 1:
        return grid(mesh, seq_parallel, model_parallel)
    return mesh


def grid(mesh: Mesh, seq_parallel: int, model_parallel: int = 1) -> Mesh:
    """The ranks of ``mesh``'s group laid out as a (world // (seq *
    model), seq, model) grid of (data, seq, model): rank r at data ``r //
    (seq * model)``, seq ``(r // model) % seq`` and model ``r % model``
    (the TPU package's ``make_mesh`` reshape, model innermost), with a
    subgroup for its seq row, its model row (also on gloo, for host flags)
    and its data column (also on gloo, for host counts). Every rank of the
    group calls it with the same sizes."""
    world = mesh.world
    inner = seq_parallel * model_parallel
    if seq_parallel < 1 or model_parallel < 1 or world % inner:
        raise ValueError(f"{world} ranks do not form rows of seq_parallel={seq_parallel} x "
                         f"model_parallel={model_parallel}")
    backend = dist.get_backend(mesh.group)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    n_data = world // inner

    def at(d, s, m):
        return (d * seq_parallel + s) * model_parallel + m

    groups = {}

    def make(ranks, names, cpu_twin):
        g = dist.new_group(ranks, backend=backend, timeout=timeout)
        gc = (g if backend == "gloo" else dist.new_group(ranks, backend="gloo", timeout=timeout)
              ) if cpu_twin else None
        if mesh.rank in ranks:
            groups[names[0]] = g
            if cpu_twin:
                groups[names[1]] = gc

    # every rank creates every subgroup, in one order
    if seq_parallel > 1:
        for d in range(n_data):
            for m in range(model_parallel):
                make([at(d, s, m) for s in range(seq_parallel)], ("seq_group",), False)
    if model_parallel > 1:
        for d in range(n_data):
            for s in range(seq_parallel):
                make([at(d, s, m) for m in range(model_parallel)],
                     ("model_group", "model_cpu_group"), True)
    for s in range(seq_parallel):
        for m in range(model_parallel):
            make([at(d, s, m) for d in range(n_data)], ("data_group", "data_cpu_group"), True)
    return dataclasses.replace(mesh, data=n_data, seq=seq_parallel, model=model_parallel,
                               **groups)


def shutdown(mesh: Optional[Mesh]) -> None:
    """Leave the group ``mesh`` was formed over, if any."""
    if mesh is not None and mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()
