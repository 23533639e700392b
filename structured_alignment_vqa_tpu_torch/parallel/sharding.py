"""Placing the state and the batches of a data-parallel run, and the
collectives it needs (the data-axis half of the TPU package's
``parallel/sharding.py``).

The TPU package replicates the parameters and shards every batch tensor's
leading dimension over the data axis; GSPMD then inserts the reductions.
Here each rank holds a full copy of the state (rank 0's, broadcast by
:func:`shard_params`) and its own rows of the global batch
(:func:`put_batch`), and the step calls the reductions itself.

Every collective of the data axis is built from ``all_reduce`` and
``broadcast``: PyTorch lists only those two (and ``barrier``) for gloo on
CUDA tensors, so the same code runs on NCCL, on gloo over CUDA and on gloo
over the CPU. An
all-gather is an ``all_reduce`` of a zero-filled ``(world, n)`` buffer in
which each rank writes its own row (x + 0 is x exactly), padded to the
longest rank's length, which one small all-reduce of the sizes on the
host's gloo group gives first.

The seq axis's collectives (:func:`seq_all_gather`, :func:`seq_all_to_all`,
:func:`seq_rotate`) run over a seq row's subgroup (``Mesh.seq_group``). On
NCCL they take the device tensors; on gloo a CUDA tensor passes through
pinned host memory first (gloo's send and receive hand its raw pointer to
the TCP transport; its all-gather and all-to-all are staged alike), so
that the same code runs on NCCL, on gloo over CUDA and on gloo over the
CPU. The ring's step is one message a rank: its tensors'
bytes packed into one buffer, sent to the previous rank of the row while
the next rank's is received.

The model axis (``param_pspec``: vocab-split tables, column/row-split FFN
and head kernels) is not ported (ROADMAP Queue 1 item 15b).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, List, Sequence

import torch
import torch.distributed as dist

from structured_alignment_vqa_tpu_torch.parallel.mesh import Mesh

if TYPE_CHECKING:   # the batch's package imports the model, which imports this module
    from structured_alignment_vqa_tpu_torch.data.batch import VQABatch

# gradients are summed in flat buckets of at most this many bytes; a
# gradient at least this large is summed alone, in place
BUCKET_BYTES = 64 * 2 ** 20


def batch_sharding(mesh: Mesh) -> torch.device:
    """Where this rank's rows of every batch tensor live."""
    return mesh.device


def put_batch(batch: VQABatch, mesh: Mesh) -> VQABatch:
    """This rank's rows of the global batch, on its device. The loader
    already strides the samples by rank (``BatchLoader(shard_idx,
    num_shards)``), so the rows are the rank's shard: rank-major, as the
    TPU package's ``put_batch`` lays out the global array."""
    return batch.to(batch_sharding(mesh))


def host_sum(values: Sequence[float], mesh: Mesh) -> List[float]:
    """The sum over ranks of a few host numbers (float64 on the host's gloo
    group: integers up to 2^53 stay exact)."""
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, group=mesh.cpu_group)
    return t.tolist()


def _group(mesh: Mesh, t: torch.Tensor):
    """The group for ``t``: host tensors go over the host's gloo group."""
    return mesh.cpu_group if t.device.type == "cpu" else mesh.group


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over the ranks (no gradient)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=_group(mesh, out))
    return out


def _unique(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in tensors:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append(t)
    return out


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite each tensor with rank 0's, in place (a storage several
    names share, as the one GloVe table of ``share_glove``, once). Host
    tensors (Adam's step counts) go over the host's gloo group."""
    for t in _unique(tensors):
        dist.broadcast(t, src=0, group=_group(mesh, t))


def shard_params(model: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer of ``model`` replicated from rank 0."""
    broadcast_(model.state_dict().values(), mesh)


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> int:
    """Sum ``grads`` over the ranks, in place; returns the bytes summed.

    Gradients of one dtype are packed into flat buckets of at most
    ``BUCKET_BYTES`` and summed one bucket at a time; a gradient at least
    that large is summed alone without a copy. Every rank must pass
    gradients of the same shapes in the same order.
    """
    total = 0
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if bucket:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=mesh.group)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
        bucket, size = [], 0

    for g in grads:
        nbytes = g.numel() * g.element_size()
        total += nbytes
        if nbytes >= BUCKET_BYTES:
            dist.all_reduce(g, group=mesh.group)
            continue
        if bucket and (g.dtype != bucket[0].dtype or size + nbytes > BUCKET_BYTES):
            flush()
        bucket.append(g)
        size += nbytes
    flush()
    return total


def _gather_layout(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[List[int]]:
    """``sizes[r][i]``: the number of elements of tensor ``i`` on rank ``r``."""
    mine = [t.numel() for t in tensors]
    table = [0.0] * (mesh.world * len(mine))
    table[mesh.rank * len(mine):(mesh.rank + 1) * len(mine)] = mine
    flat = host_sum(table, mesh)
    return [[int(v) for v in flat[r * len(mine):(r + 1) * len(mine)]]
            for r in range(mesh.world)]


def _exchange(flat_parts: Sequence[torch.Tensor], sizes: List[List[int]], mesh: Mesh,
              like: torch.Tensor) -> List[torch.Tensor]:
    """All-reduce of the zero-filled (world, longest) buffer holding each
    rank's parts in its own row; returns each part's rank-major
    concatenation."""
    longest = max(sum(row) for row in sizes)
    buf = torch.zeros(mesh.world, longest, dtype=like.dtype, device=like.device)
    mine = sum(sizes[mesh.rank])
    if mine:
        buf[mesh.rank, :mine] = torch.cat([p.reshape(-1).to(like.dtype) for p in flat_parts])
    dist.all_reduce(buf, group=_group(mesh, buf))
    out = []
    for i in range(len(flat_parts)):
        pieces = []
        for r, row in enumerate(sizes):
            off = sum(row[:i])
            pieces.append(buf[r, off:off + row[i]])
        out.append(torch.cat(pieces))
    return out


@torch.no_grad()
def gather_rows(tensors: Sequence[torch.Tensor], mesh: Mesh,
                dtype: torch.dtype = torch.int64) -> tuple:
    """``(gathered, sizes)``: for each tensor, every rank's elements
    flattened and concatenated in rank order, in ``dtype`` (no gradient;
    one collective for all of them), and ``sizes[r][i]``, the number of
    elements tensor ``i`` has on rank ``r``. A rank may hold more or fewer
    elements than another."""
    sizes = _gather_layout(tensors, mesh)
    like = torch.empty((), dtype=dtype, device=tensors[0].device)
    return _exchange(list(tensors), sizes, mesh, like), sizes


class _GatherScores(torch.autograd.Function):
    """Float32 all-gather whose backward sums the gathered gradient over
    the ranks and returns this rank's slice of it."""

    @staticmethod
    def forward(ctx, mesh, sizes, *tensors):
        ctx.mesh, ctx.sizes = mesh, sizes
        ctx.shapes = [t.shape for t in tensors]
        like = torch.empty((), dtype=torch.float32, device=tensors[0].device)
        return tuple(_exchange(tensors, sizes, mesh, like))

    @staticmethod
    def backward(ctx, *grads):
        mesh, sizes = ctx.mesh, ctx.sizes
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        out, off = [], 0
        for i, shape in enumerate(ctx.shapes):
            start = off + sum(row[i] for row in sizes[:mesh.rank])
            out.append(flat[start:start + sizes[mesh.rank][i]].reshape(shape))
            off += sum(row[i] for row in sizes)
        return (None, None, *out)


def gather_scores(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """For each tensor, every rank's elements flattened and concatenated in
    rank order, in float32, with a gradient.

    The gradient of a rank's local tensor is its slice of the gathered
    gradient summed over the ranks: a rank whose own rows read other ranks'
    scores (the relation rewrite's joint softmax) sends them their share.
    A term that every rank computes identically from the gathered scores
    (the relation MIL-NCE) must therefore enter each rank's loss divided by
    the world size, so that the sum counts it once: a full term on every
    rank would come back ``world`` times over.
    """
    sizes = _gather_layout(tensors, mesh)
    return list(_GatherScores.apply(mesh, sizes, *[t.float() for t in tensors]))


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        out = t.clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.mesh.group)
        return None, out


def sum_over_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, with a gradient: each rank's output
    feeds its own rows, so the backward sums the ranks' gradients too."""
    return _SumOverRanks.apply(mesh, t)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must pass through host memory on ``group``: a CUDA
    tensor on a gloo group."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


@torch.no_grad()
def seq_all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The shards ``x`` of the ranks of this rank's seq row, concatenated
    in seq order along ``dim`` (no gradient)."""
    group = mesh.seq_group
    staged = _staged(x, group)
    src = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.seq)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


@torch.no_grad()
def seq_all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_to_all_single`` over this rank's seq row: ``x`` is (seq, ...)
    and its slice j goes to the row's rank j; the result's slice i came
    from the row's rank i."""
    group = mesh.seq_group
    staged = _staged(x, group)
    src = _to_host(x) if staged else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


@torch.no_grad()
def seq_rotate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """One step of the ring: ``tensors`` sent to the previous rank of the
    seq row and the next rank's received in their place (after t steps a
    rank holds the blocks that started on the rank t places after it).
    One message of all their bytes each way; :attr:`seq_rotate.bytes`
    counts the bytes this rank sent."""
    group = mesh.seq_group
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    staged = _staged(flat, group)
    send = _to_host(flat) if staged else flat
    recv = (torch.empty(send.shape, dtype=send.dtype, pin_memory=True) if staged
            else torch.empty_like(send))
    dst, src = mesh.seq_peer(-1), mesh.seq_peer(1)
    if dist.get_backend(group) == "nccl":
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                       dist.P2POp(dist.irecv, recv, src, group)])
    else:   # gloo: both posted before either waits
        reqs = [dist.isend(send, dst, group=group), dist.irecv(recv, src, group=group)]
    for req in reqs:
        req.wait()
    if staged:
        recv = recv.to(flat.device)
    seq_rotate.bytes += flat.numel()
    out, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        # a copy: the view of another dtype needs its own aligned storage
        out.append(recv[off:off + n].clone().view(t.dtype).reshape(t.shape))
        off += n
    return out


seq_rotate.bytes = 0
