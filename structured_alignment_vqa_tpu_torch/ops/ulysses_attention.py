"""Ulysses-style (all-to-all head-sharded) sequence-parallel graph attention
(counterpart of the TPU package's ``ops/ulysses_attention.py``).

Instead of rotating K/V blocks around the row (``ops/ring_attention.py``),
two all-to-alls re-partition the heads over this rank's seq row:

    in:  (B, L/n, C)   sequence-sharded
    ->   (B, L, C/n)   head-sharded: split channels, gather the sequence
    K4 on h/n heads over the whole sequence
    ->   (B, L/n, C)   back: split the sequence, gather channels

Rank j keeps channel chunk j, which is heads [j h/n, (j+1) h/n) in the
kernel's channel-chunk head layout, so no merge across ranks is needed and
the single-device kernel runs unmodified: K4 emits its statistics in the
forward, and the backward (K5, then K6) runs on the head-sharded tensors
between the same two all-to-alls taken the other way. The masks and the
graph are whole on every rank. Constraints: ``L % n == 0`` and
``num_heads % n == 0``.

:func:`ulysses_graph_attention` has the ring's contract: whole (B, L, C)
tensors in and out on every rank of the row, the gradients gathered the
same way (``ring_attention.SeqShardedAttention``).
"""

from __future__ import annotations

import torch

from structured_alignment_vqa_tpu_torch.ops.flash_graph_attention import (
    _forward,
    flash_graph_attention_bwd,
)
from structured_alignment_vqa_tpu_torch.ops.ring_attention import SeqShardedAttention
from structured_alignment_vqa_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import seq_all_to_all


def to_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(B, L/n, C) -> (B, L, C/n): this rank keeps its channel chunk of
    every rank's rows, concatenated in seq order (= global order)."""
    b, lq, c = x.shape
    n = mesh.seq
    parts = x.reshape(b, lq, n, c // n).permute(2, 0, 1, 3)     # chunk j goes to rank j
    got = seq_all_to_all(parts, mesh)                            # rank i's rows, my chunk
    return got.permute(1, 0, 2, 3).reshape(b, n * lq, c // n)


def from_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(B, L, C/n) -> (B, L/n, C): the exact inverse of :func:`to_heads`."""
    b, length, cn = x.shape
    n = mesh.seq
    parts = x.reshape(b, n, length // n, cn).permute(1, 0, 2, 3)   # rows of rank i go to i
    got = seq_all_to_all(parts, mesh)                               # my rows, chunk of rank j
    return got.permute(1, 2, 0, 3).reshape(b, length // n, n * cn)


def _ulysses_local(q, k, v, key_mask, query_mask, graph, rows, num_heads, renorm, mesh):
    heads = num_heads // mesh.seq
    qh, kh, vh = (to_heads(t[:, rows].contiguous(), mesh) for t in (q, k, v))
    km, qm, g = key_mask.contiguous(), query_mask.contiguous(), graph.contiguous()
    out_h, m, z, bsum = _forward(qh, kh, vh, km, qm, g, heads, renorm, "stats")
    return from_heads(out_h, mesh), (qh, kh, vh, km, qm, g, out_h, m, z, bsum)


def _ulysses_local_backward(saved, dy, num_heads, renorm, mesh):
    qh, kh, vh, km, qm, g, out_h, m, z, bsum = saved
    dy_h = to_heads(dy, mesh)
    grads = flash_graph_attention_bwd(qh, kh, vh, km, qm, g, out_h, m, z, bsum, dy_h,
                                      num_heads // mesh.seq, renorm)
    return tuple(from_heads(d, mesh) for d in grads)


def ulysses_graph_attention(q, k, v, key_mask, query_mask, graph, num_heads: int,
                            renorm: str, mesh: Mesh, seq_axis: str = SEQ_AXIS):
    """Ulysses attention over this rank's seq row; arguments and result as
    ``ring_attention.ring_graph_attention``."""
    n = mesh.seq
    length = q.shape[1]
    if length % n:
        raise ValueError(f"Ulysses needs L={length} divisible by '{seq_axis}'={n}")
    if num_heads % n:
        raise ValueError(
            f"Ulysses shards heads: num_heads={num_heads} must divide by "
            f"'{seq_axis}'={n} (use the ring for n > num_heads)")
    return SeqShardedAttention.apply(q, k, v, key_mask, query_mask, graph, num_heads, renorm,
                                     mesh, _ulysses_local, _ulysses_local_backward)
