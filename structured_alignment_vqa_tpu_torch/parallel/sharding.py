"""Placing the state and the batches of a parallel run, and the
collectives it needs (counterpart of the TPU package's
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

The model axis. :func:`param_pspec` is the TPU package's rule, by name
and shape, on the port's state_dict names: the GloVe and embedding tables
(and the int8 table with its per-row scales) split by vocab rows, 2-D
kernels column-split where they widen (the attention projections, so the
heads split too; ``fc1``, ``syb_mlp``, the heads' hidden layers) and
row-split where they narrow (``fc2``, ``syb_mlp2``, ``cls_hidden``); the
rest, and any dimension the axis does not divide, stays whole. A flax
kernel is (in, out) and ``nn.Linear.weight`` (out, in): a column split is
the port's dim 0, a row split its dim 1. :func:`shard_params` slices each
rank's shard out of rank 0's broadcast and marks each split module with a
:class:`Split`. GSPMD computes the single-device program on such a
layout; here the split layers call Megatron's collectives over the model
row (``Mesh.model_group``) themselves: :func:`copy_to_model` (identity,
all-reduce backward) before a column-split layer, :func:`reduce_from_model`
(all-reduce, identity backward) after a row-split one,
:func:`gather_columns` (all-gather, this rank's slice backward) after a
column-split layer whose consumer is whole, :func:`gather_heads`
(all-gather keeping the heads a rank's columns overlap, backward summed
over the row) where the axis does not divide the heads and a head spans
ranks, :func:`scatter_columns` (the reverse of :func:`gather_columns`)
before a row-split layer whose input is whole, and
:func:`vocab_lookup` (the ids outside the shard masked, the local rows
looked up, then reduced). A column-split layer's bias is replicated but
each rank uses only its slice, so its gradient is partial
(:func:`model_partial_grads`): the step sums it over the model row.
:func:`full_state_dict` gathers the shards back into whole tensors, for
checkpoints in the one-process layout.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Sequence

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


def shard_params(model: torch.nn.Module, mesh: Mesh, keep_whole: Sequence[str] = ()) -> None:
    """Every parameter and buffer of ``model`` replicated from rank 0;
    then, with ``mesh.model > 1``, each rank keeps its shard of the split
    ones (:func:`shard_model`; ``keep_whole`` names stay replicated)."""
    if mesh.group is not None:
        broadcast_(model.state_dict().values(), mesh)
    if mesh.model > 1:
        shard_model(model, mesh, keep_whole)


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


# ---- the model axis ----------------------------------------------------------

# A vocab dimension below this size is not split (the TPU package's rule).
MIN_SHARD_DIM = 1024


def param_pspec(name: str, shape: Sequence[int], model_axis_size: int) -> Optional[int]:
    """The dimension of the port's tensor ``name`` (a state_dict name) that
    the model axis splits, or None where it stays whole: the TPU package's
    ``param_pspec`` on the flax leaf ``name`` maps to
    (``models/convert.py:name_map``). Tables (``syb_emb.weight``, int8
    ``syb_emb.weight_q``, ``lookup_table``) and the int8 row scales
    (``syb_emb.weight_scale``) split by vocab rows, dim 0, from
    ``MIN_SHARD_DIM`` rows; a 2-D ``weight`` or int8 ``weight_q`` (out, in)
    splits dim 0 (columns, flax ``P(None, 'model')``) where out >= in, and
    dim 1 (rows, ``P('model', None)``) where in > out, when the axis
    divides that dimension into at least 4 a rank."""
    n = model_axis_size
    if n <= 1:
        return None
    mod, _, leaf = name.rpartition(".")
    glove = mod.rpartition(".")[2] == "syb_emb"
    if (glove and leaf in ("weight", "weight_q")) or leaf == "lookup_table":
        return 0 if shape[0] >= MIN_SHARD_DIM and shape[0] % n == 0 else None
    if glove and leaf == "weight_scale":
        return 0 if shape[0] >= MIN_SHARD_DIM and shape[0] % n == 0 else None
    if leaf in ("weight", "weight_q") and len(shape) == 2:
        fout, fin = shape
        if fout >= fin and fout % n == 0 and fout >= 4 * n:
            return 0
        if fin > fout and fin % n == 0 and fin >= 4 * n:
            return 1
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """How a module's tensors are split over the model row: ``dim`` of the
    weight (0: columns of a Linear, or vocab rows of a table; 1: rows of a
    Linear), ``n`` shards, this rank's ``index``, and ``mesh`` for the
    model row's group. ``names`` are the module's tensors the split cuts,
    ``shape0`` the first dimension of this rank's shard of them."""

    dim: int
    n: int
    index: int
    mesh: Mesh
    names: tuple = ("weight",)
    shape0: int = 0

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's shard of the whole ``t`` along ``dim``."""
        size = t.shape[dim] // self.n
        return t.narrow(dim, self.index * size, size)


def _model_group(mesh: Mesh, t: torch.Tensor):
    return mesh.model_cpu_group if t.device.type == "cpu" else mesh.model_group


def _all_gather_model(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model row's shards ``t`` concatenated along ``dim`` in model
    order (a CUDA tensor on gloo passes through pinned host memory)."""
    group = _model_group(mesh, t)
    staged = _staged(t, group)
    src = _to_host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.model)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def _all_reduce_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=_model_group(mesh, out))
    model_bytes.sent += out.numel() * out.element_size()
    return out


def model_bytes():
    """The bytes this rank has passed to the model row's collectives so far
    (``model_bytes.sent``): each all-reduce's tensor, each all-gather's
    whole output."""
    return model_bytes.sent


model_bytes.sent = 0


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_model(grad, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_model(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = _all_gather_model(x, mesh, x.dim() - 1)
        model_bytes.sent += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        size = grad.shape[-1] // mesh.model
        return grad.narrow(-1, mesh.model_index * size, size).contiguous(), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        size = x.shape[-1] // mesh.model
        return x.narrow(-1, mesh.model_index * size, size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        out = _all_gather_model(grad, ctx.mesh, grad.dim() - 1)
        model_bytes.sent += out.numel() * out.element_size()
        return out, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, whose gradient is summed over the model row: the input of a
    column-split layer, each rank's backward giving its part of dx."""
    return _Copy.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model row (a row-split layer's partial
    products); the gradient passes unchanged to every rank's part."""
    return _Reduce.apply(x, mesh)


def gather_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model row's column shards of ``x`` concatenated on the last axis;
    the backward takes this rank's slice of the gradient."""
    return _Gather.apply(x, mesh)


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, lo, hi):
        ctx.mesh, ctx.lo, ctx.hi, ctx.cols = mesh, lo, hi, x.shape[-1]
        out = _all_gather_model(x, mesh, x.dim() - 1)
        model_bytes.sent += out.numel() * out.element_size()
        return out[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, grad):
        mesh, cols = ctx.mesh, ctx.cols
        whole = grad.new_zeros(*grad.shape[:-1], cols * mesh.model)
        whole[..., ctx.lo:ctx.hi] = grad
        whole = _all_reduce_model(whole, mesh)
        return whole.narrow(-1, mesh.model_index * cols, cols).contiguous(), None, None, None


def gather_heads(x: torch.Tensor, mesh: Mesh, h_lo: int, h_hi: int,
                 head_dim: int) -> torch.Tensor:
    """Heads ``[h_lo, h_hi)`` (``head_dim`` columns each) of the model row's
    column shards ``x`` concatenated on the last axis: the heads a rank's
    columns overlap when a head spans several ranks.

    The backward puts the heads' gradient back at their columns, zeros
    elsewhere, sums it over the model row and keeps this rank's columns.
    Two ranks that compute one head for different output columns each hold
    only their share of its dq, dk and dv; the sum adds the shares (a slice,
    as :func:`gather_columns`'s backward, would drop the other rank's)."""
    return _GatherHeads.apply(x, mesh, h_lo * head_dim, h_hi * head_dim)


def head_range(index: int, cols: int, head_dim: int) -> tuple:
    """``(h_lo, h_hi)``: the heads that columns ``[index * cols, (index + 1)
    * cols)`` overlap (``head_dim`` columns a head)."""
    return index * cols // head_dim, -(-(index + 1) * cols // head_dim)


def scatter_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's column shard of the whole ``x`` (the input of a row-split
    layer); the backward gathers the shards' gradients."""
    if not x.requires_grad:
        size = x.shape[-1] // mesh.model
        return x.narrow(-1, mesh.model_index * size, size).contiguous()
    return _Scatter.apply(x, mesh)


def vocab_lookup(ids: torch.Tensor, split: Split, lookup) -> torch.Tensor:
    """``lookup(local_ids)`` of a vocab-split table: the ids outside this
    rank's rows read row 0 of the shard and are zeroed, then the ranks'
    rows are summed (each id has one nonzero row: the sum is exact)."""
    rows = split.shape0
    local = ids - split.index * rows
    inside = (local >= 0) & (local < rows)
    out = lookup(torch.where(inside, local, torch.zeros_like(local)))
    out = torch.where(inside.unsqueeze(-1), out, torch.zeros((), dtype=out.dtype,
                                                              device=out.device))
    return reduce_from_model(out, split.mesh)


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh, keep_whole: Sequence[str] = ()) -> None:
    """Keep this rank's shard of every tensor :func:`param_pspec` splits
    (in place: a parameter keeps its identity) and mark its module with a
    :class:`Split`. ``keep_whole``: names that stay replicated (the sparse
    table). A tensor several names share is split once."""
    from structured_alignment_vqa_tpu_torch.models.att_model_x3 import link_model_splits

    n = mesh.model
    state = model.state_dict(keep_vars=True)
    done = {id(state[name]) for name in keep_whole}
    for name, t in state.items():
        dim = param_pspec(name, tuple(t.shape), n)
        if dim is None or id(t) in done:
            continue
        done.add(id(t))
        mod_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(mod_name)
        prev = getattr(module, "model_split", None)
        size = t.shape[dim] // n
        t.data = t.data.narrow(dim, mesh.model_index * size, size).contiguous()
        module.model_split = Split(dim, n, mesh.model_index, mesh,
                                   (prev.names + (leaf,)) if prev is not None else (leaf,),
                                   t.shape[0])
    link_model_splits(model)


def model_partial_grads(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The replicated parameters whose gradient each rank computes only in
    part: the biases of column-split Linears (each rank adds its slice)."""
    out = []
    for m in model.modules():
        split = getattr(m, "model_split", None)
        bias = getattr(m, "bias", None)
        if (split is not None and split.dim == 0 and isinstance(bias, torch.nn.Parameter)
                and "bias" not in split.names):
            out.append(bias)
    return out


def split_of(model: torch.nn.Module) -> Dict[str, Split]:
    """state_dict name -> :class:`Split` of every split tensor of ``model``."""
    out = {}
    for mod_name, m in model.named_modules():
        split = getattr(m, "model_split", None)
        for leaf in split.names if split is not None else ():
            out[f"{mod_name}.{leaf}" if mod_name else leaf] = split
    return out


@torch.no_grad()
def unshard(t: torch.Tensor, split: Split, dim: int) -> torch.Tensor:
    """The whole tensor of the model row's shards ``t`` (split on ``dim``)."""
    return _all_gather_model(t.detach(), split.mesh, dim)


@torch.no_grad()
def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split tensor gathered whole, in
    the one-process layout (every rank of the model row must call it). A
    model with no split tensor gives its own state_dict."""
    sd = model.state_dict()
    # by storage: the tied names of one tensor (share_glove's slots) share it
    splits = {sd[name].data_ptr(): split for name, split in split_of(model).items()}
    if not splits:
        return sd
    whole = {}
    for t in sd.values():
        split = splits.get(t.data_ptr())
        if split is not None and t.data_ptr() not in whole:
            whole[t.data_ptr()] = unshard(t, split, split.dim)
    return {name: whole.get(t.data_ptr(), t) for name, t in sd.items()}


@torch.no_grad()
def full_grads(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient (the ones that have one), the split ones
    gathered whole over the model row (every rank of it must call this)."""
    splits = split_of(model)
    return {n: unshard(p.grad, splits[n], splits[n].dim) if n in splits else p.grad.detach()
            for n, p in model.named_parameters() if p.grad is not None}
