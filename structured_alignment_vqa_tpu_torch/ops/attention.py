"""The attention family (counterpart of the TPU package's ``ops/attention.py``).

* :class:`MultiHeadAttention`   — vanilla MHA (decoder self-attention).
* :class:`GraphGuidedAttention` — softmax -> x graph -> L1 renorm.
* :class:`GraphMaskAttention`   — softmax -> x graph -> sum+eps renorm.

Reference numerics kept: Q/K/V projections are Linear followed by ReLU;
head h owns channels [h*dh, (h+1)*dh); key and query masks are
``sign(|sum(x, -1)|)`` of the *unprojected* inputs; masked logits are filled
with -2^32+1; scores, softmax and renorm are float32.

Dispatch: graph attention with an l1 or sum_eps renorm and no causal mask
goes, for any Tq, through
:func:`~structured_alignment_vqa_tpu_torch.ops.fused_graph_attention.fused_graph_attention_ln`
while Tk <= ``MAX_KEYS`` (512), and above that through
:func:`~structured_alignment_vqa_tpu_torch.ops.flash_graph_attention.flash_graph_attention`
followed by the eager residual + LayerNorm (the CUDA kernels on the card,
their plain versions on the CPU); everything else runs
:func:`attention_core` in eager PyTorch. The
1-token self-attention of the decoder computes no attention at all and
reduces to ``query_mask * V(x)``.

The ablation variants (``models/variants.py``) add three things: a module
built with ``return_att`` also returns the attention weights, one with a
``dropout_rate`` drops attention weights in train mode (the mask drawn
from the ``generator`` passed to ``forward``), and a graph may broadcast
over the query or key axis (a (B, Tq, 1) query-validity column). A call
that returns weights or draws dropout runs :func:`attention_core` on every
device, as the TPU package's dispatch does: the kernels compute neither.

Sequence parallelism (the TPU package's ``ops/attention.py:162-264``): a
module built with ``seq_axis`` (the encoders' self-attention of
AttModelX3 under ``ModelConfig.seq_axis``) runs graph self-attention with
an l1 or sum_eps renorm, no causal mask, no weights out and no dropout
draw, through ring (``seq_impl="ring"``, ``ops/ring_attention.py``) or
Ulysses attention (``"ulysses"``, ``ops/ulysses_attention.py``) when the
ambient mesh (``parallel/context.py``) has that axis with more than one
rank; a length the axis does not divide warns and takes the
single-device path, as in the TPU package.

The model axis (``parallel/sharding.py``) splits the Q/K/V projections by
columns over a model row, whatever the head count (the TPU package's rule,
whose GSPMD reshards the heads). Where the row's size divides the heads, a
rank computes its own heads; where it does not, a head may span ranks, and
a rank computes every head its columns overlap (``gather_heads``), keeps
its columns of their output and gathers the row's. Under such a split
Ulysses, whose rule the TPU package states on whole heads, runs on all
heads of q, k and v gathered whole.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
from torch import nn

from structured_alignment_vqa_tpu_torch.ops.flash_graph_attention import flash_graph_attention
from structured_alignment_vqa_tpu_torch.ops.fused_graph_attention import (
    L1_NORM_EPS,
    MAX_KEYS,
    SUM_NORM_EPS,
    attention_ln,
    fused_graph_attention_ln,
    graph_attention_heads,
)
from structured_alignment_vqa_tpu_torch.ops.layers import (
    NEG_MASK_VALUE,
    LNParams,
    dense_relu,
    layer_norm,
    linear_relu,
)
from structured_alignment_vqa_tpu_torch.ops.ring_attention import ring_graph_attention
from structured_alignment_vqa_tpu_torch.ops.ulysses_attention import ulysses_graph_attention
from structured_alignment_vqa_tpu_torch.parallel.context import current_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    copy_to_model,
    gather_columns,
    gather_heads,
    head_range,
)


def content_mask(x: torch.Tensor) -> torch.Tensor:
    """``sign(|sum(x, -1)|)`` summed in float32: 0 for all-zero (padding) rows.

    A real row whose sum cancels to exactly 0.0 is masked too, as in the
    reference; post-LN rows at fresh init (gamma 1, beta 0) sit on that knife
    edge, so comparisons perturb LayerNorm parameters first.
    """
    return torch.sign(torch.abs(x.float().sum(dim=-1)))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H) with head h owning channels [h*dh, (h+1)*dh)."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    query_mask: torch.Tensor,
    num_heads: int,
    graph: Optional[torch.Tensor] = None,
    renorm: Optional[str] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    drawn: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared attention math of the three variants, in eager PyTorch.

    Returns ``(output (B, Tq, C) in q's dtype, att_weights (B, H, Tq, Tk))``;
    ``att_weights`` is post-renorm and pre-query-mask. ``graph`` is
    (B, Tq, Tk) or broadcasts to it. With ``dropout_rate > 0`` the weights
    are dropped after the query mask and before the product with V, kept
    ones scaled by ``1 / (1 - dropout_rate)``, the mask drawn from
    ``generator``; the caller passes a rate only in train mode. ``drawn =
    (h_lo, h_hi, H)``: the heads are heads ``[h_lo, h_hi)`` of ``H``, and
    the mask is drawn for all ``H`` and sliced, so that a model row's
    ranks, whether each computes whole heads or a head spans several, drop
    one process's weights (the generator advances as in one process).
    """
    tq, tk = q.shape[1], k.shape[1]
    dh = q.shape[-1] // num_heads
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))

    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / (dh ** 0.5)
    scores = scores.masked_fill(key_mask.float()[:, None, None, :] == 0.0, NEG_MASK_VALUE)
    if causal:
        future = torch.ones(tq, tk, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(future, NEG_MASK_VALUE)
    att = torch.softmax(scores, dim=-1)

    if graph is not None:
        att = att * graph.float()[:, None, :, :]
    if renorm == "l1":
        att = att / att.abs().sum(dim=-1, keepdim=True).clamp_min(L1_NORM_EPS)
    elif renorm == "sum_eps":
        att = att / (att.sum(dim=-1, keepdim=True) + SUM_NORM_EPS)
    elif renorm is not None:
        raise ValueError(f"unknown renorm mode: {renorm!r}")

    att_weights = att
    att = att * query_mask.float()[:, None, :, None]
    if dropout_rate > 0.0:
        shape = att.shape if drawn is None else (att.shape[0], drawn[2], *att.shape[2:])
        keep = torch.bernoulli(torch.full(shape, 1.0 - dropout_rate, device=att.device),
                               generator=generator)
        if drawn is not None:
            keep = keep[:, drawn[0]:drawn[1]]
        att = torch.where(keep.bool(), att / (1.0 - dropout_rate), torch.zeros_like(att))
    out = torch.matmul(att.to(vh.dtype).float(), vh.float())
    return _merge_heads(out).to(q.dtype), att_weights


class _AttentionBase(nn.Module):
    """ReLU'd Q/K/V projections (``Q_proj.0`` ...) + post-LN (``normalization``).

    ``dropout_rate`` drops attention weights in train mode; ``return_att``
    makes ``forward`` return ``(out, att_weights)``. AttModelX3 uses
    neither; the MIL variants do. ``seq_axis`` and ``seq_impl`` make graph
    self-attention sequence-parallel over the ambient mesh's axis of that
    name (module docstring).
    """

    renorm: Optional[str] = None

    def __init__(self, num_units: int, num_heads: int = 8, causality: bool = False,
                 dtype: torch.dtype = torch.float32, device=None,
                 dropout_rate: float = 0.0, return_att: bool = False,
                 seq_axis: Optional[str] = None, seq_impl: str = "ring"):
        super().__init__()
        self.num_heads = num_heads
        self.causality = causality
        self.dropout_rate = dropout_rate
        self.return_att = return_att
        self.seq_axis = seq_axis
        self.seq_impl = seq_impl
        self.Q_proj = linear_relu(num_units, num_units, dtype, device)
        self.K_proj = linear_relu(num_units, num_units, dtype, device)
        self.V_proj = linear_relu(num_units, num_units, dtype, device)
        self.normalization = LNParams(num_units, device)

    def _finish(self, out, queries):
        return layer_norm(out + queries, self.normalization.gamma, self.normalization.beta)

    def _project(self, queries, keys, values, v_only: bool = False, all_heads: bool = False):
        """``(q, k, v, heads, whole, drawn)``: the ReLU'd projections, the
        heads this rank computes, what makes their output whole, and
        ``attention_core``'s ``drawn``: under a model split the rank's heads'
        place among all ``num_heads``, so that every rank slices one
        process's dropout mask; None where the heads are all of them.
        Split over the model axis, the projections are this rank's columns
        (each distinct input passed once through ``copy_to_model``). Where
        the axis divides the heads, a rank computes its ``num_heads / n``
        heads and ``whole`` gathers the model row's columns; where it does
        not, a head may span ranks, and a rank computes every head its
        columns overlap (gathered by ``gather_heads``) and ``whole`` takes
        its columns of their output and gathers them. ``all_heads`` (Ulysses
        under such a split) gathers q, k and v whole instead, and the output
        is whole as it is. Not split: all heads and the identity; ``v_only``
        projects V alone."""
        split = self.Q_proj[0].model_split
        if split is None:
            v = self.V_proj(values)
            if v_only:
                return None, None, v, self.num_heads, lambda out: out, None
            return (self.Q_proj(queries), self.K_proj(keys), v, self.num_heads,
                    lambda out: out, None)
        mesh = split.mesh
        copies = {}

        def local(proj, x):
            if id(x) not in copies:
                copies[id(x)] = copy_to_model(x, mesh)
            return dense_relu(proj, copies[id(x)], copied=True, local_out=True)

        v = local(self.V_proj, values)
        if v_only:
            return None, None, v, None, lambda out: gather_columns(out, mesh), None
        q, k = local(self.Q_proj, queries), local(self.K_proj, keys)
        if self.num_heads % split.n == 0:
            per = self.num_heads // split.n
            return (q, k, v, per, lambda out: gather_columns(out, mesh),
                    (split.index * per, (split.index + 1) * per, self.num_heads))
        if all_heads:
            q, k, v = (gather_columns(t, mesh) for t in (q, k, v))
            return q, k, v, self.num_heads, lambda out: out, None
        cols = v.shape[-1]
        head_dim = cols * split.n // self.num_heads
        h_lo, h_hi = head_range(split.index, cols, head_dim)
        q, k, v = (gather_heads(t, mesh, h_lo, h_hi, head_dim) for t in (q, k, v))
        offset = split.index * cols - h_lo * head_dim

        def whole(out):
            return gather_columns(out[..., offset:offset + cols].contiguous(), mesh)

        return q, k, v, h_hi - h_lo, whole, (h_lo, h_hi, self.num_heads)

    def _run(self, queries, keys, values, graph, generator=None):
        renorm = self.renorm
        b, tq, tk = queries.shape[0], queries.shape[1], keys.shape[1]
        dropout_rate = self.dropout_rate if self.training else 0.0
        # 1-token self-attention (the decoder's): softmax over one key is 1,
        # so the block is LN(query_mask * V(x) + x). Exact only without a
        # graph and renorm, as in the TPU package.
        if tq == 1 and tk == 1 and graph is None and renorm is None and dropout_rate == 0.0:
            _, _, v, _, whole, _ = self._project(queries, keys, values, v_only=True)
            v = whole(v * content_mask(queries)[..., None].to(v.dtype))
            out = self._finish(v, queries)
            if self.return_att:
                return out, torch.ones(b, self.num_heads, 1, 1, device=out.device)
            return out

        # The kernels return no attention weights and draw no dropout, so a
        # call that asks for either runs attention_core on every device: the
        # TPU package's dispatch rule (its kernels exclude return_att and a
        # dropout rng alike), not a fallback from a failed launch.
        kernels = (graph is not None and renorm is not None and not self.causality
                   and not self.return_att and dropout_rate == 0.0)
        seq_mesh = self._seq_mesh(queries, keys) if kernels else None
        q, k, v, heads, whole, drawn = self._project(
            queries, keys, values, all_heads=seq_mesh is not None and self.seq_impl == "ulysses")
        key_mask, query_mask = content_mask(keys), content_mask(queries)
        if kernels:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            # the kernels read a whole (B, Tq, Tk) graph: expand a broadcast one
            graph = graph.float().expand(b, tq, tk).contiguous()
            if seq_mesh is not None:
                seq_attention = (ulysses_graph_attention if self.seq_impl == "ulysses"
                                 else ring_graph_attention)
                out = seq_attention(q, k, v, key_mask, query_mask, graph, heads, self.renorm,
                                    seq_mesh, self.seq_axis)
                return self._finish(whole(out), queries)
            if keys.shape[1] > MAX_KEYS:
                # long sequences: the K-blocked kernels, then residual + LayerNorm
                out = flash_graph_attention(q, k, v, key_mask, query_mask, graph, heads, renorm)
                return self._finish(whole(out), queries)
            if self.Q_proj[0].model_split is not None:
                # the model axis: this rank's heads, their outputs gathered,
                # then the residual and the LayerNorm on every column
                o = whole(graph_attention_heads(q, k, v, key_mask, query_mask, graph, heads,
                                                renorm))
                return attention_ln(o, queries.to(q.dtype), self.normalization.gamma,
                                    self.normalization.beta)
            return fused_graph_attention_ln(
                q, k, v, key_mask, query_mask, graph, queries.to(q.dtype).contiguous(),
                self.normalization.gamma, self.normalization.beta, self.num_heads, renorm,
            )

        out, att = attention_core(q, k, v, key_mask, query_mask, heads, graph=graph,
                                  renorm=renorm, causal=self.causality,
                                  dropout_rate=dropout_rate, generator=generator, drawn=drawn)
        out = self._finish(whole(out), queries)
        if self.return_att:
            return out, att
        return out

    def _seq_mesh(self, queries, keys):
        """The ambient mesh when ring or Ulysses attention over its
        ``seq_axis`` takes this call (self-attention only), or None where
        the call takes the single-device path."""
        mesh = current_mesh()
        if self.seq_axis is None or mesh is None or queries.shape != keys.shape:
            return None
        n_seq = mesh.shape.get(self.seq_axis, 1)
        if n_seq <= 1:
            return None
        if queries.shape[1] % n_seq:
            warnings.warn(
                f"ring attention skipped: L={queries.shape[1]} not divisible by "
                f"{self.seq_axis}={n_seq}; falling back to the single-device kernel (pick "
                "bucket maxlens divisible by the seq axis)", stacklevel=3)
            return None
        return mesh


class MultiHeadAttention(_AttentionBase):
    """Vanilla MHA (reference ``modules.py:119-207``)."""

    renorm = None

    def forward(self, queries, keys, values, generator=None):
        return self._run(queries, keys, values, None, generator)


class GraphGuidedAttention(_AttentionBase):
    """softmax -> x graph -> L1 renorm (reference ``modules.py:210-311``)."""

    renorm = "l1"

    def forward(self, queries, keys, values, graph, generator=None):
        return self._run(queries, keys, values, graph, generator)


class GraphMaskAttention(_AttentionBase):
    """softmax -> x graph -> sum+1e-7 renorm (reference ``modules.py:314-403``).

    ``graph=None`` skips the multiply and keeps the renorm, as in the TPU
    package (the reference's shipped body crashes on None).
    """

    renorm = "sum_eps"

    def forward(self, queries, keys, values, graph=None, generator=None):
        if graph is None:
            # mask-only attention: a ones graph, exact under the multiply
            graph = torch.ones(queries.shape[0], queries.shape[1], keys.shape[1],
                               device=queries.device)
        return self._run(queries, keys, values, graph, generator)
