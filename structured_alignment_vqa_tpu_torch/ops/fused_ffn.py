"""Fused position-wise FFN + residual + LayerNorm (K3).

Counterpart of the TPU package's ``ops/pallas_ffn.py`` (``_kernel``, entry
``fused_ffn``): ``LN(W2 relu(W1 x + b1) + b2 + x)`` over rows, with the
(rows, 4C) hidden activation kept on chip.

On CUDA tensors :func:`fused_ffn` launches the kernel of ``csrc/ffn.cu``
(bf16: ``mma.sync`` tiles of 64 rows; with few rows the hidden width is
split over blocks by :func:`ffn_split` and a second kernel sums the shards,
counted as one launch; f32: SIMT; C 2048, either dtype: the wide SIMT
kernel, 8 rows a block); on CPU tensors it runs
:func:`ffn_ln_plain`, the same function in plain PyTorch, rounding where
the kernel rounds: the hidden activation is cast to x's dtype before the
second product and the residual is added in f32. The
backward on either device is autograd of :func:`ffn_ln_composite`, whose
products run in x's dtype, as the TPU package's backward is the VJP of its
``_composite``: both pair a kernel forward with a composite backward.
Weights are in ``nn.Linear`` layout: w1 (4C, C), w2 (C, 4C).

The model axis (``ops/layers.py:FeedForward`` with its hidden width split
over the model row) takes two more entries of the same kernels:
:func:`ffn_partial`, the f32 ``relu(x W1s^T + b1s) W2s^T`` of this rank's
hidden shard (the bf16 kernel may split its own shard over blocks, the
partials summed in order by a second kernel), and, after the sum over the
ranks, :func:`ffn_epilogue`, the shard-sum kernel with one partial: ``+ b2
+ x`` and the LayerNorm. Their backwards are autograd of
:func:`ffn_partial_composite` (products in x's dtype) and of
:func:`ffn_epilogue_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from structured_alignment_vqa_tpu_torch.ops import _build
from structured_alignment_vqa_tpu_torch.ops.dispatch import (
    SM_COUNT,
    SMEM_LIMIT,
    composite_backward,
    use_kernel,
)
from structured_alignment_vqa_tpu_torch.ops.layers import layer_norm

WIDTHS = (128, 256, 512)   # C values the row-tile kernels are compiled for
# C values past the row-tile kernels' shared memory: csrc/ffn.cu's wide
# kernel (8 rows a block on CUDA cores, both dtypes, no hidden split)
WIDE_WIDTHS = (2048,)
HIDDEN_CHUNK = 64          # the hidden width must be a multiple of this
TC_ROWS = 64               # rows per block of the bf16 tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta):
    """Plain PyTorch version of the kernel: same shape and dtype as ``x``."""
    h = torch.relu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    y = F.linear(h.float(), w2.float(), b2.float())
    return layer_norm(y + x.float(), gamma, beta).to(x.dtype)


def ffn_ln_composite(x, w1, b1, w2, b2, gamma, beta):
    """The TPU package's ``pallas_ffn._composite``: both products and the
    residual in x's dtype (bf16 operands sum in f32 and round once), the
    LayerNorm in f32. In float32 it is :func:`ffn_ln_plain` operation for
    operation. K3's backward is autograd of this function."""
    h = torch.relu(F.linear(x, w1, b1))
    y = F.linear(h, w2, b2)
    return layer_norm(y + x, gamma, beta)


def ffn_split(rows: int, c: int, hidden: int) -> tuple:
    """``(n_split, chunks_per_split)`` of the bf16 kernel: how many shards
    the ``hidden / 64`` hidden chunks are cut into, and the chunks of each.
    A pure function of the shapes (C does not change it: the row tile is 64
    rows at every width). One shard when the 64-row tiles alone fill the
    card's 132 SMs, else as many as there are SMs per tile, none empty."""
    tiles = -(-rows // TC_ROWS)
    chunks = hidden // HIDDEN_CHUNK
    want = max(1, min(chunks, SM_COUNT // tiles))
    per = -(-chunks // want)
    return -(-chunks // per), per


def kernel_ffn_split(dtype, rows: int, c: int, hidden: int) -> tuple:
    """The split a call takes: :func:`ffn_split` on the bf16 tensor-core
    kernel; float32's SIMT kernel and the wide kernel walk every chunk in
    one block."""
    if dtype == torch.bfloat16 and c not in WIDE_WIDTHS:
        return ffn_split(rows, c, hidden)
    return 1, hidden // HIDDEN_CHUNK


def smem_bytes_tc(c: int) -> int:
    """Dynamic shared memory of one block of the bf16 kernel (must match
    ``TcSmem`` in ``csrc/ffn.cu``): the x tile and the W1 chunk (64 rows of
    C + 8), the W2 chunk (C rows of 72), the hidden chunk (64 x 72), all
    bf16, and 8 x 64 f32 row sums."""
    return 2 * (2 * TC_ROWS * (c + 8) + c * (HIDDEN_CHUNK + 8) + TC_ROWS * (HIDDEN_CHUNK + 8)) \
        + 4 * 8 * TC_ROWS


def ffn_epilogue_plain(y, x, b2, gamma, beta):
    """Plain PyTorch version of :func:`ffn_epilogue`: ``LN((y + b2) + x)``
    in f32 over the last axis (y f32), in x's dtype."""
    return layer_norm((y + b2.float()) + x.float(), gamma, beta).to(x.dtype)


def shard_sum_plain(partial, x, b2, gamma, beta):
    """Plain PyTorch version of the split path's second kernel: the shards'
    f32 partial ``h W2^T`` (n_split, rows, C) summed in shard order, ``+ b2
    + x`` in f32, then the LayerNorm; (rows, C) in x's dtype."""
    y = partial[0]
    for part in partial[1:]:
        y = y + part
    return ffn_epilogue_plain(y, x, b2, gamma, beta)


def ffn_partial_plain(x, w1, b1, w2):
    """Plain PyTorch version of :func:`ffn_partial`: ``relu(x W1^T + b1)``
    rounded to x's dtype, times ``W2^T``, f32 (..., C)."""
    h = torch.relu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    return F.linear(h.float(), w2.float())


def ffn_partial_composite(x, w1, b1, w2):
    """:func:`ffn_partial` as ``ffn_ln_composite`` computes it, products in
    x's dtype; its backward is the partial entry's."""
    return F.linear(torch.relu(F.linear(x, w1, b1)), w2)


def _check(x, w1, b1, w2, b2, gamma, beta) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    hd = w1.shape[0]
    if c not in WIDTHS + WIDE_WIDTHS:
        raise ValueError(f"the FFN kernel is built for C in {WIDTHS + WIDE_WIDTHS}, got {c}")
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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    c = x.shape[-1]
    rows, hidden = x.numel() // c, w1.shape[0]
    n_split, per = kernel_ffn_split(x.dtype, rows, c, hidden)
    out = torch.empty_like(x)
    # the shards' f32 partial y, summed by the second kernel
    partial = (torch.empty(n_split, rows, c, dtype=torch.float32, device=x.device)
               if n_split > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            rows, c, hidden, _DTYPES[x.dtype], n_split, per, stream,
        )
    _build.check(status, "ffn_ln kernel")
    fused_ffn.launches += 1
    return out


class _FusedFFN(torch.autograd.Function):
    """K3 as an autograd node.

    The forward launches the kernel on CUDA tensors (the plain version on
    CPU tensors) and saves only its inputs; it adds the residual in f32, as
    the TPU kernel does. The TPU package has no backward kernel for K3: its
    backward is the VJP of ``_composite`` (``ops/pallas_ffn.py:88-107``).
    So is this one: the backward recomputes :func:`ffn_ln_composite` on the
    saved inputs under ``torch.enable_grad()`` and takes
    ``torch.autograd.grad`` of it, its products running in x's dtype on
    cuBLAS as XLA's do. This is the backward pass, not a forward that falls
    back.
    """

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta)
        if not use_kernel(x):
            return ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
        return _launch(x, w1, b1, w2, b2, gamma, beta)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(ffn_ln_composite, ctx, grad_out)


def fused_ffn(x, w1, b1, w2, b2, gamma, beta):
    """``LN(W2 relu(W1 x + b1) + b2 + x)`` over the last axis of ``x``,
    differentiable.

    x (..., C); w1 (H, C), b1 (H,), w2 (C, H), b2 (C,) in x's dtype; gamma
    and beta (C,) float32.
    """
    return _FusedFFN.apply(x, w1, b1, w2, b2, gamma, beta)


fused_ffn.launches = 0


# ---- the model axis ---------------------------------------------------------

def _check_partial(x, w1, b1, w2) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c, hd = x.shape[-1], w1.shape[0]
    if c not in WIDTHS:
        raise ValueError(f"the FFN partial is built for C in {WIDTHS}, got {c}")
    if hd % HIDDEN_CHUNK:
        raise ValueError(f"hidden shard {hd} is not a multiple of {HIDDEN_CHUNK}")
    for name, t, shape in (("x", x, tuple(x.shape)), ("w1", w1, (hd, c)), ("b1", b1, (hd,)),
                           ("w2", w2, (c, hd))):
        if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} {x.dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_partial(x, w1, b1, w2) -> torch.Tensor:
    _check_partial(x, w1, b1, w2)
    lib = _build.library("ffn")
    fn = lib.savqa_ffn_partial
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    c = x.shape[-1]
    rows, hidden = x.numel() // c, w1.shape[0]
    n_split, per = kernel_ffn_split(x.dtype, rows, c, hidden)
    out = torch.empty(*x.shape, dtype=torch.float32, device=x.device)
    scratch = (torch.empty(n_split, rows, c, dtype=torch.float32, device=x.device)
               if n_split > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                    rows, c, hidden, _DTYPES[x.dtype], n_split, per, stream)
    _build.check(status, "ffn_partial kernel")
    ffn_partial.launches += 1
    return out


def _launch_epilogue(y, x, b2, gamma, beta) -> torch.Tensor:
    c = x.shape[-1]
    if x.dtype not in _DTYPES or c not in WIDTHS:
        raise ValueError(f"the FFN epilogue is built for C in {WIDTHS}, f32 or bf16; got "
                         f"{c} {x.dtype}")
    for name, t, shape, dtype in (("y", y, tuple(x.shape), torch.float32),
                                  ("b2", b2, (c,), x.dtype), ("gamma", gamma, (c,), torch.float32),
                                  ("beta", beta, (c,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    lib = _build.library("ffn")
    fn = lib.savqa_ffn_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(y.data_ptr(), x.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                    beta.data_ptr(), out.data_ptr(), x.numel() // c, c, _DTYPES[x.dtype], stream)
    _build.check(status, "ffn_epilogue kernel")
    ffn_epilogue.launches += 1
    return out


class _FFNPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2):
        ctx.save_for_backward(x, w1, b1, w2)
        if not use_kernel(x):
            return ffn_partial_plain(x, w1, b1, w2)
        return _launch_partial(x, w1, b1, w2)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(ffn_partial_composite, ctx, grad_out)


class _FFNEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x, b2, gamma, beta):
        ctx.save_for_backward(y, x, b2, gamma, beta)
        if not use_kernel(x):
            return ffn_epilogue_plain(y, x, b2, gamma, beta)
        return _launch_epilogue(y.contiguous(), x, b2, gamma, beta)

    @staticmethod
    def backward(ctx, grad_out):
        return composite_backward(ffn_epilogue_plain, ctx, grad_out)


def ffn_partial(x, w1, b1, w2):
    """``relu(x W1^T + b1) W2^T`` over the last axis of ``x``, f32 (...,
    C), differentiable: one rank's share of the FFN on the model axis, w1
    (Hs, C), b1 (Hs,), w2 (C, Hs) its hidden shard, in x's dtype. One
    launch of ``csrc/ffn.cu:savqa_ffn_partial`` on CUDA tensors."""
    return _FFNPartial.apply(x.contiguous(), w1.contiguous(), b1.contiguous(), w2.contiguous())


ffn_partial.launches = 0


def ffn_epilogue(y, x, b2, gamma, beta):
    """``LN((y + b2) + x)`` over the last axis, in x's dtype,
    differentiable: y f32, the ranks' :func:`ffn_partial` summed. One launch
    of ``csrc/ffn.cu:savqa_ffn_epilogue`` on CUDA tensors."""
    return _FFNEpilogue.apply(y, x.contiguous(), b2.contiguous(), gamma, beta)


ffn_epilogue.launches = 0
