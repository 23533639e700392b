"""int8 weight-only serving (counterpart of the TPU package's
``ops/quant.py``).

The GloVe-backed table (407k x 300 float32, ~0.5 GB; three of them without
``share_glove``) and the classifier heads dominate the model's bytes.
Weight-only int8 keeps those weights as int8 with float32 scales and
dequantizes where they are used:

* an embedding lookup gathers int8 rows and their per-row scales and
  dequantizes the gathered rows only (:func:`quantized_lookup`);
* a head's matmul takes the int8 weight converted to the compute dtype; the
  per-output-channel scale commutes with the contraction
  (``sum_i x_i q_ji s_j = s_j sum_i x_i q_ji``), so it multiplies the small
  output once (:class:`QDense`).

Quantization is symmetric: ``q = round(w / s)`` with ``s = amax|w| / 127``
per table row or per output channel. Activations stay in the compute dtype.
Training is untouched: :func:`quantize_state_dict` converts a trained float
state_dict once, and a model built with ``ModelConfig.int8_serving=True``
holds the int8 layout (``...syb_emb.weight_q`` / ``weight_scale``,
``cls*.{0,3}.weight_q`` / ``weight_scale`` / ``bias``; ``models/convert.py``
lists them). No kernel of the TPU package computes this, so neither does a
kernel here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def quantize_int8(w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization with one scale per slice along ``axis``.

    Returns ``(q, scale)``: ``q`` int8 of w's shape and ``scale`` float32 of
    shape ``(w.shape[axis],)``, ``w ~= q * scale`` broadcast along ``axis``.
    An all-zero slice gets scale 1 (its q is all zero), so dequantized rows
    keep exact zeros.
    """
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=reduce_axes)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.rint(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def quantized_lookup(q_table: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Gather int8 rows and their scales; dequantize the gathered rows only."""
    rows = q_table[ids].to(dtype)
    s = scale[ids].to(dtype)
    return rows * s[..., None]


class QDense(nn.Module):
    """Weight-only int8 linear layer, in place of ``ops/layers.py:Linear``
    at serving. Buffers (from :func:`quantize_state_dict`, not training):
    ``weight_q`` int8 (out, in), ``weight_scale`` float32 (out,), ``bias``
    float32 (out,). On the model axis ``weight_q`` splits as the float
    weight does and the scale and bias stay whole (the TPU package's
    ``kernel_q`` and ``kernel_scale``): ``ops/layers.py:split_dense``."""

    model_split = None

    def __init__(self, fin: int, fout: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(fout, fin, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(fout, device=device))
        self.register_buffer("bias", torch.zeros(fout, device=device))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        split = self.model_split
        if split is None:
            y = torch.matmul(x.to(dt), self.weight_q.to(dt).t())
            return y * self.weight_scale.to(dt) + self.bias.to(dt)
        # imported here: ops/layers.py's module imports nothing of this one
        from structured_alignment_vqa_tpu_torch.ops.layers import split_dense

        w = self.weight_q.to(dt).t()
        scale = self.weight_scale.to(dt)
        if split.dim == 0:   # this rank's output channels: their scales
            return split_dense(x.to(dt), split, lambda v: torch.matmul(v, w) * split.local(scale),
                               self.bias.to(dt))
        return split_dense(x.to(dt), split, lambda v: torch.matmul(v, w) * scale,
                           self.bias.to(dt))


# The modules the int8 model holds quantized, matched by NAME, not by
# structure, as in the TPU package (so a module that merely looks like a
# table is never quantized by mistake): the GloVe lookups (``syb_emb`` in
# each branch; one shared module with ``share_glove``) and the classifier
# heads' two Linears (``cls`` or ``cls_mcb``, ``cls_vis``, ``cls_syb``: ``.0``
# and ``.3``). The MCB head's frozen sketches (``mcb.sketch*``) stay float.
GLOVE_MODULE_NAMES = frozenset({"syb_emb"})
HEAD_PREFIX = "cls"


def quantize_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A trained float state_dict in the int8-serving layout (the TPU
    package's ``quantize_params``).

    * a GloVe module (last name in ``GLOVE_MODULE_NAMES``, sole entry ``weight``)
      becomes ``weight_q`` int8 + per-row ``weight_scale``; tied names of one
      table are quantized once;
    * a head Linear (first name starting with ``HEAD_PREFIX``, entries
      ``weight`` and ``bias``) becomes ``weight_q`` int8 + per-output-channel
      ``weight_scale`` + the float ``bias``.

    Everything else passes through unchanged (the decoder's lookup tables,
    the attention and FFN weights stay float). Raises if a matched name has
    other entries (already quantized, or a changed layout), or if fewer
    than 1 table or 6 head layers were matched.
    """
    modules: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in state_dict.items():
        mod, _, leaf = name.rpartition(".")
        modules.setdefault(mod, {})[leaf] = t
    out: Dict[str, torch.Tensor] = {}
    done: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
    tables, heads = set(), 0
    for mod, entries in modules.items():
        parts = mod.split(".")
        if parts[-1] in GLOVE_MODULE_NAMES:
            if set(entries) != {"weight"}:
                raise ValueError(f"GloVe module {mod} has entries {sorted(entries)}, expected "
                                 "exactly ['weight']: already quantized, or the layout changed?")
            w = entries["weight"]
            key = (w.device, w.data_ptr(), tuple(w.shape))
            if key not in done:
                q, s = quantize_int8(w.detach().cpu().numpy(), axis=0)
                done[key] = (torch.from_numpy(q), torch.from_numpy(s))
            tables.add(key)
            out[f"{mod}.weight_q"], out[f"{mod}.weight_scale"] = done[key]
        elif parts[0].startswith(HEAD_PREFIX):
            if set(entries) != {"weight", "bias"}:
                raise ValueError(f"classifier head {mod} has entries {sorted(entries)}, "
                                 "expected ['bias', 'weight']")
            q, s = quantize_int8(entries["weight"].detach().cpu().numpy(), axis=0)
            out[f"{mod}.weight_q"], out[f"{mod}.weight_scale"] = (torch.from_numpy(q),
                                                                  torch.from_numpy(s))
            out[f"{mod}.bias"] = entries["bias"]
            heads += 1
        else:
            out.update({f"{mod}.{leaf}" if mod else leaf: t for leaf, t in entries.items()})
    # the model has at least one GloVe table and three heads of two Linears:
    # fewer means this is not an AttModelX3 float state_dict
    if len(tables) < 1 or heads < 6:
        raise ValueError(f"quantize_state_dict matched {len(tables)} GloVe table(s) and "
                         f"{heads} head layer(s); expected >=1 and >=6: wrong state_dict or "
                         "renamed modules?")
    return out
