"""Core non-attention primitives (counterpart of the TPU package's ``ops/layers.py``).

Reference numerics kept on purpose:

* LayerNorm adds epsilon to the *standard deviation* and the std is the
  unbiased (N-1) estimator; a constant row has std 0 and maps to beta.
* The feed-forward block is Linear(d->4d)+ReLU -> Linear(4d->d) with residual
  and post-LayerNorm; on CUDA tensors it is one kernel (``ops/fused_ffn.py``).
* Embedding optionally zeroes row 0 on every lookup and scales by sqrt(d).
* Dropout draws its mask from a ``torch.Generator`` the caller passes in.

Parameters are kept in float32 and cast to the compute dtype where they are
used, as ``nn.Dense(dtype=...)`` does in the TPU package.

On the model axis (``parallel/sharding.py:shard_model``) a ``Linear``,
``Embedding`` or ``FeedForward`` whose tensors are split holds its shard
and a ``model_split``: a column-split Linear computes its columns of the
output and gathers them (or leaves them local for a row-split consumer,
``local_out``), a row-split one takes its columns of the input (or a
column-split producer's, ``local_in``) and sums the ranks' products, a
vocab-split table looks up the ids of its rows and sums the ranks' rows,
and the FFN runs K3's partial and epilogue entries around a sum over the
model row (``ops/fused_ffn.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    copy_to_model,
    gather_columns,
    reduce_from_model,
    scatter_columns,
    vocab_lookup,
)

# Mask fill value of the reference attention family: float(-2**32 + 1).
NEG_MASK_VALUE = float(-(2**32) + 1)
LN_EPS = 1e-8


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               epsilon: float = LN_EPS) -> torch.Tensor:
    """``gamma * (x - mean) / (std + eps) + beta`` in float32, std unbiased.

    The where-guard gives a constant row (var 0) std 0 and a zero gradient
    instead of the NaN that sqrt' at 0 would bring.
    """
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = (x32 - mean).square().sum(dim=-1, keepdim=True) / max(n - 1, 1)
    nonzero = var > 0.0
    std = torch.where(nonzero, torch.sqrt(torch.where(nonzero, var, torch.ones_like(var))),
                      torch.zeros_like(var))
    out = gamma * (x32 - mean) / (std + epsilon) + beta
    return out.to(x.dtype)


def label_smoothing(one_hot: torch.Tensor, epsilon: float = 0.1) -> torch.Tensor:
    """``(1 - eps) * y + eps / K`` over the last axis (reference ``modules.py:461-463``)."""
    k = one_hot.shape[-1]
    return (1.0 - epsilon) * one_hot + epsilon / k


def sinusoidal_position_encoding(batch: int, length: int, num_units: int,
                                 zeros_pad: bool = True, scale: bool = True,
                                 device=None) -> torch.Tensor:
    """Sinusoidal PE table for positions [0, length), broadcast to (batch,
    length, num_units) float32 (reference ``modules.py:83-116``).

    ``pos / 10000**(2i/d)`` in float64, sin on even and cos on odd columns,
    optional zeroed row 0, then float32 and the optional sqrt(d) scale, in
    the TPU package's order. It backs the ``--sinusoid`` flag of the
    ablation variants; the production model learns its PEs.
    """
    pos = np.arange(length)[:, None].astype(np.float64)
    i = np.arange(num_units)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2.0 * i / num_units)
    table = np.where(np.arange(num_units)[None, :] % 2 == 0, np.sin(angle), np.cos(angle))
    if zeros_pad:
        table[0, :] = 0.0
    out = torch.tensor(table, dtype=torch.float32, device=device)
    if scale:
        out = out * (num_units ** 0.5)
    return out.expand(batch, length, num_units)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator``, as flax's
    ``nn.Dropout``: kept entries are divided by ``1 - p`` held in x's dtype
    (flax's weakly typed ``keep_prob``), the rest are 0.

    In eval mode or at ``p == 0`` no mask is drawn and ``generator`` is
    left as it was.
    """
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full(x.shape, keep, device=x.device), generator=generator)
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask.bool(), x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Dropout whose ``forward`` takes the generator to draw its mask from.

    It holds no parameters; it takes the place of ``nn.Dropout`` (whose mask
    comes from the global generator) in the reference's module layout.
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return dropout(x, self.p, self.training, generator)


def split_dense(x, split, product, bias, copied: bool = False, local_in: bool = False,
                local_out: bool = False):
    """A split dense layer: ``product(x)`` of this rank's weight shard and
    ``bias`` (a whole vector), over the model row.

    Column split (``split.dim == 0``): ``x`` is whole (``copied``: the
    caller has passed it through ``copy_to_model``), the output's columns
    are this rank's, gathered unless ``local_out``. Row split: ``x`` is
    whole, or this rank's columns with ``local_in``; the ranks' products are
    summed before the bias."""
    mesh = split.mesh
    if split.dim == 0:
        y = product(x if copied else copy_to_model(x, mesh)) + split.local(bias)
        return y if local_out else gather_columns(y, mesh)
    y = reduce_from_model(product(x if local_in else scatter_columns(x, mesh)), mesh)
    return y + bias


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``: input, weight and bias are
    cast at use, the stored parameters stay float32. Split over the model
    axis, :func:`split_dense` (the flags as there)."""

    model_split = None

    def __init__(self, fin: int, fout: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(fin, fout, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, copied: bool = False, local_in: bool = False,
                local_out: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        if self.model_split is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        w = self.weight.to(dt)
        return split_dense(x.to(dt), self.model_split, lambda v: F.linear(v, w),
                           self.bias.to(dt), copied, local_in, local_out)


def dense_relu(layer: nn.Module, x: torch.Tensor, **flags) -> torch.Tensor:
    """``layer(x)`` of a :func:`linear_relu` (its ReLU after) or a bare
    Linear, with :func:`split_dense`'s flags."""
    if isinstance(layer, nn.Sequential):
        return layer[1](layer[0](x, **flags))
    return layer(x, **flags)


def linear_relu(fin: int, fout: int, dtype: torch.dtype, device=None) -> nn.Sequential:
    """The reference's ``Sequential(Linear, ReLU)`` (state-dict names ``.0.*``)."""
    return nn.Sequential(Linear(fin, fout, dtype, device), nn.ReLU())


class LNParams(nn.Module):
    """Bare LayerNorm parameters, named as the reference's ``normalization``."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))


class FeedForward(nn.Module):
    """Position-wise FFN with residual + post-LN (reference ``modules.py:405-447``).

    ``conv1`` is ``Linear(in, units[0]) + ReLU``, ``conv2`` is
    ``Linear(units[0], units[1])``. The whole block is
    :func:`~structured_alignment_vqa_tpu_torch.ops.fused_ffn.fused_ffn`: one
    CUDA kernel on the card, its plain version on the CPU.
    """

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = linear_relu(in_features, hidden_units[0], dtype, device)
        self.conv2 = Linear(hidden_units[0], hidden_units[1], dtype, device)
        self.normalization = LNParams(in_features, device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # imported here: ops/fused_ffn.py imports layer_norm from this module
        from structured_alignment_vqa_tpu_torch.ops.fused_ffn import (
            ffn_epilogue,
            ffn_partial,
            fused_ffn,
        )

        dt = self.compute_dtype
        fc1 = self.conv1[0]
        split = fc1.model_split
        if split is not None and self.conv2.model_split is not None:
            # the hidden width split over the model row: each rank's partial
            # h W2^T of its shard (f32), summed over the row, then + b2 + x
            # and the LayerNorm
            x = x.to(dt)
            part = ffn_partial(copy_to_model(x, split.mesh), fc1.weight.to(dt),
                               split.local(fc1.bias).to(dt), self.conv2.weight.to(dt))
            return ffn_epilogue(reduce_from_model(part, split.mesh), x,
                                self.conv2.bias.to(dt), self.normalization.gamma,
                                self.normalization.beta)
        if split is not None or self.conv2.model_split is not None:
            raise NotImplementedError("an FFN with one of its two products split over the "
                                      "model axis")
        return fused_ffn(
            x.to(dt), fc1.weight.to(dt), fc1.bias.to(dt),
            self.conv2.weight.to(dt), self.conv2.bias.to(dt),
            self.normalization.gamma, self.normalization.beta,
        )


class Embedding(nn.Module):
    """Learned lookup table (parameter ``lookup_table``) with optional zeroed
    row 0, enforced on every lookup, and optional sqrt(d) scale. Split over
    the model axis by vocab rows, :func:`~structured_alignment_vqa_tpu_torch.parallel.sharding.vocab_lookup`."""

    model_split = None

    def __init__(self, vocab_size: int, num_units: int, zeros_pad: bool = True,
                 scale: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.lookup_table = nn.Parameter(torch.empty(vocab_size, num_units, device=device))
        nn.init.xavier_normal_(self.lookup_table)
        self.num_units = num_units
        self.zeros_pad = zeros_pad
        self.scale = scale
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.model_split is None:
            out = F.embedding(ids, self.lookup_table)
        else:
            out = vocab_lookup(ids, self.model_split,
                               lambda local: F.embedding(local, self.lookup_table))
        if self.zeros_pad:
            out = out.masked_fill((ids == 0).unsqueeze(-1), 0.0)
        out = out.to(self.compute_dtype)
        if self.scale:
            out = out * math.sqrt(self.num_units)
        return out
