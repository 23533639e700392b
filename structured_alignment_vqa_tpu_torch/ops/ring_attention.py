"""Ring (sequence-sharded) graph-guided attention over a seq row of ranks
(counterpart of the TPU package's ``ops/ring_attention.py``).

Each rank of a seq row (``parallel/mesh.py``) takes a contiguous slice of
the token sequence: its query rows, its K/V rows and key mask, and its row
stripe of the adjacency (``graph[:, my_rows, :]``, every column). K, V and
the key mask rotate around the row (``parallel/sharding.py:seq_rotate``);
the adjacency never moves, because the columns a rank needs at ring step t
are the slice ``src * L/n`` of its own stripe, src = (rank + t) % n.

Each step is one launch of K4 with ``emit="partial"`` (the kernel of
``ops/flash_graph_attention.py``, whatever the shard's length: K1 has no
partial emit): the raw ``(a, m, z, b)`` of the local queries against the
current key block, merged online (:func:`merge`)

    m = max(m, m_t),  c = exp(m_old - m),  c_t = exp(m_t - m),
    z = c z + c_t z_t,  b = c b + c_t b_t,  a = c a + c_t a_t

and renormalised once at the end (l1: ``a / max(b, 1e-12 z)``, sum_eps:
``a / (b + 1e-7 z)``), then the query mask. The merged m, z, b are the
global row statistics, so the backward runs K5 and K6 on each block
unchanged: dq accumulates on its rank in float32, and dk and dv accumulate
in float32 on the rotating block and arrive at their owner after the last
rotation. Partials sum in float32 as in the single-device kernel; only the
order across shards differs.

:func:`ring_graph_attention` takes the whole (B, L, C) tensors, identical
on every rank of the row (the rows of one data rank), and returns the
whole output on each: its rank's rows gathered over the row. Its backward
gathers the rows' dq, dk and dv the same way, so every rank of the row
holds the same full gradients and nothing is summed over the seq axis. On
CUDA tensors the steps launch K4, K5 and K6; on CPU tensors their plain
versions run the same loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from structured_alignment_vqa_tpu_torch.ops.flash_graph_attention import (
    _renormalise,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_graph_attention,
    masked_grad_and_delta,
)
from structured_alignment_vqa_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import seq_all_gather, seq_rotate


def _weight(m: torch.Tensor, m_new: torch.Tensor) -> torch.Tensor:
    """exp(m - m_new), 0 where m is -inf: a set that saw no key counts
    nothing, also where both are -inf (whose exp(m - m_new) is NaN)."""
    return torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - m_new))


def merge(m, z, bsum, a, m_t, z_t, b_t, a_t):
    """Online-softmax merge of two partial sets ``(m, z, b)`` (B, H, Tq) and
    ``a`` (B, H, Tq, dh) (the TPU package's ``_merge``)."""
    m_new = torch.maximum(m, m_t)
    c, c_t = _weight(m, m_new), _weight(m_t, m_new)
    return (m_new, z * c + z_t * c_t, bsum * c + b_t * c_t,
            a * c[..., None] + a_t * c_t[..., None])


def _column_block(graph_rows: torch.Tensor, src: int, block: int) -> torch.Tensor:
    return graph_rows[:, :, src * block:(src + 1) * block].contiguous()


def ring_forward_shard(q, k, v, key_mask, query_mask, graph_rows, num_heads: int,
                       renorm: str, mesh: Mesh):
    """This rank's rows: ``(out (B, L/n, C), m, z, b)``, the statistics (B,
    H, L/n) float32 of every key. ``q, k, v`` (B, L/n, C), the masks (B,
    L/n), ``graph_rows`` (B, L/n, L), all this rank's."""
    b, lq, c = q.shape
    lk = k.shape[1]
    n, idx = mesh.seq, mesh.seq_index
    m = torch.full((b, num_heads, lq), -torch.inf, dtype=torch.float32, device=q.device)
    z, bsum = torch.zeros_like(m), torch.zeros_like(m)
    a = torch.zeros(b, num_heads, lq, c // num_heads, dtype=torch.float32, device=q.device)
    block = [k, v, key_mask]
    for t in range(n):
        g_blk = _column_block(graph_rows, (idx + t) % n, lk)
        a_t, m_t, z_t, b_t = flash_graph_attention(q, *block, query_mask, g_blk, num_heads,
                                                   renorm, emit="partial")
        m, z, bsum, a = merge(m, z, bsum, a, m_t, z_t, b_t, a_t)
        if t < n - 1:
            block = seq_rotate(block, mesh)
    return _renormalise(a, z, bsum, query_mask, renorm, q.dtype), m, z, bsum


def ring_backward_shard(q, k, v, key_mask, query_mask, graph_rows, out, m, z, bsum, dy,
                        num_heads: int, renorm: str, mesh: Mesh):
    """``(dq, dk, dv)`` of this rank's rows from its forward's results and
    ``dy`` (B, L/n, C), the gradient of its rows of the output."""
    lk = k.shape[1]
    n, idx = mesh.seq, mesh.seq_index
    d_out, delta = masked_grad_and_delta(out, dy, query_mask, num_heads)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for t in range(n):
        g_blk = _column_block(graph_rows, (idx + t) % n, lk)
        args = (q, k, v, key_mask, g_blk, m, z, bsum, delta, d_out, num_heads, renorm)
        dq += flash_bwd_dq(*args).float()
        dk_t, dv_t = flash_bwd_dkv(*args)
        dk += dk_t.float()
        dv += dv_t.float()
        # the accumulators travel with their block: after the n-th step
        # every block, and its dk and dv, is home again
        if t < n - 1:
            k, v, key_mask, dk, dv = seq_rotate([k, v, key_mask, dk, dv], mesh)
        else:
            dk, dv = seq_rotate([dk, dv], mesh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ring_local(q, k, v, key_mask, query_mask, graph, rows, num_heads, renorm, mesh):
    local = [t[:, rows].contiguous() for t in (q, k, v, key_mask, query_mask, graph)]
    out, m, z, bsum = ring_forward_shard(*local, num_heads, renorm, mesh)
    return out, (*local, out, m, z, bsum)


def _ring_local_backward(saved, dy, num_heads, renorm, mesh):
    return ring_backward_shard(*saved, dy, num_heads, renorm, mesh)


def local_rows(mesh: Mesh, length: int) -> slice:
    """This rank's slice of a sequence of ``length`` split over its seq row."""
    block = length // mesh.seq
    return slice(mesh.seq_index * block, (mesh.seq_index + 1) * block)


class SeqShardedAttention(torch.autograd.Function):
    """Whole (B, L, C) tensors in and out on every rank of a seq row; ``fwd``
    computes this rank's rows of the output (and what its backward keeps),
    ``bwd`` its rows of dq, dk and dv from its rows of the output's
    gradient. The output and the gradients are gathered over the row."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str,
                mesh: Mesh, fwd: Callable, bwd: Callable):
        rows = local_rows(mesh, q.shape[1])
        out, saved = fwd(q, k, v, key_mask, query_mask, graph, rows, num_heads, renorm, mesh)
        ctx.save_for_backward(*saved)
        ctx.meta = (rows, num_heads, renorm, mesh, bwd)
        return seq_all_gather(out, mesh, dim=1)

    @staticmethod
    def backward(ctx, grad_out):
        rows, num_heads, renorm, mesh, bwd = ctx.meta
        grads = bwd(ctx.saved_tensors, grad_out[:, rows].contiguous(), num_heads, renorm, mesh)
        return (*(seq_all_gather(g, mesh, dim=1) for g in grads),) + (None,) * 8


def ring_graph_attention(q, k, v, key_mask, query_mask, graph, num_heads: int, renorm: str,
                         mesh: Mesh, seq_axis: str = SEQ_AXIS):
    """Ring attention over this rank's seq row: ``q, k, v`` (B, L, C), the
    masks (B, L) and ``graph`` (B, L, L) float32, the same on every rank of
    the row; returns out (B, L, C) in q's dtype, differentiable in q, k and
    v. L must be divisible by the row's size."""
    n = mesh.seq
    length = q.shape[1]
    if length % n:
        raise ValueError(
            f"ring attention needs seq length {length} divisible by the "
            f"'{seq_axis}' mesh axis ({n}); pick a bucket maxlen that is")
    return SeqShardedAttention.apply(q, k, v, key_mask, query_mask, graph, num_heads, renorm,
                                     mesh, _ring_local, _ring_local_backward)
