"""Fused position-wise FFN + residual + LayerNorm (K3).

Counterpart of the TPU package's ``ops/pallas_ffn.py`` (``_kernel``, entry
``fused_ffn``): ``LN(W2 relu(W1 x + b1) + b2 + x)`` over rows, with the
(rows, 4C) hidden activation kept on chip.

On CUDA tensors :func:`fused_ffn` launches the kernel of ``csrc/ffn.cu``;
on CPU tensors it runs :func:`ffn_ln_plain`, the same function in plain
PyTorch, rounding where the kernel rounds: the hidden activation is cast to
x's dtype before the second product and the residual is added in f32. The
backward on either device is autograd of :func:`ffn_ln_plain`, as the TPU
package's is autodiff of its composite.
Weights are in ``nn.Linear`` layout: w1 (4C, C), w2 (C, 4C).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from structured_alignment_vqa_tpu_torch.ops import _build
from structured_alignment_vqa_tpu_torch.ops.dispatch import use_kernel
from structured_alignment_vqa_tpu_torch.ops.layers import layer_norm

WIDTHS = (128, 256, 512)   # C values the kernel is compiled for
HIDDEN_CHUNK = 64          # the hidden width must be a multiple of this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta):
    """Plain PyTorch version of the kernel: same shape and dtype as ``x``."""
    h = torch.relu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    y = F.linear(h.float(), w2.float(), b2.float())
    return layer_norm(y + x.float(), gamma, beta).to(x.dtype)


def _check(x, w1, b1, w2, b2, gamma, beta) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    hd = w1.shape[0]
    if c not in WIDTHS:
        raise ValueError(f"the FFN kernel is built for C in {WIDTHS}, got {c}")
    if hd % HIDDEN_CHUNK:
        raise ValueError(f"hidden width {hd} is not a multiple of {HIDDEN_CHUNK}")
    want = {
        "x": (x, tuple(x.shape), x.dtype),
        "w1": (w1, (hd, c), x.dtype), "b1": (b1, (hd,), x.dtype),
        "w2": (w2, (c, hd), x.dtype), "b2": (b2, (c,), x.dtype),
        "gamma": (gamma, (c,), torch.float32), "beta": (beta, (c,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, w1, b1, w2, b2, gamma, beta) -> torch.Tensor:
    _check(x, w1, b1, w2, b2, gamma, beta)
    lib = _build.library("ffn")
    fn = lib.savqa_ffn_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    c = x.shape[-1]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            x.numel() // c, c, w1.shape[0], _DTYPES[x.dtype], stream,
        )
    _build.check(status, "ffn_ln kernel")
    fused_ffn.launches += 1
    return out


class _FusedFFN(torch.autograd.Function):
    """K3 as an autograd node.

    The forward launches the kernel on CUDA tensors (the plain version on
    CPU tensors) and saves only its inputs. The TPU package has no backward
    kernel for K3: its backward is the VJP of the composite
    (``ops/pallas_ffn.py:106-107``). So is this one: the backward recomputes
    :func:`ffn_ln_plain` on the saved inputs under ``torch.enable_grad()``
    and takes ``torch.autograd.grad`` of it, its products running on cuBLAS
    as XLA's do. This is the backward pass, not a forward that falls back.
    """

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta)
        if not use_kernel(x):
            return ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
        return _launch(x, w1, b1, w2, b2, gamma, beta)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ffn_ln_plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_ffn(x, w1, b1, w2, b2, gamma, beta):
    """``LN(W2 relu(W1 x + b1) + b2 + x)`` over the last axis of ``x``,
    differentiable.

    x (..., C); w1 (H, C), b1 (H,), w2 (C, H), b2 (C,) in x's dtype; gamma
    and beta (C,) float32.
    """
    return _FusedFFN.apply(x, w1, b1, w2, b2, gamma, beta)


fused_ffn.launches = 0
