"""Which version of a kernel a wrapper runs.

A wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors; there is no switch between the two. A launch
that fails raises: nothing falls back to the plain version. K1, K2, K4's
forward and its backward K5 and K6 each have two CUDA kernels, and
:func:`kernel_path` says which one K2 takes: the tensor cores for
bfloat16 at head widths that are multiples of 16 up to ``TC_MAX_HEAD_DIM``
(128), else the CUDA cores ("simt"). On the CUDA cores K2 in float32 runs
register-tiled FFMA kernels (``csrc/simt_f32.cuh``) at head widths that are
multiples of 4 up to 128 (:func:`f32_tiled`;
``fused_graph_attention.k2_path``); above 128 K2 is composed of K1's or
K4's forward, its LayerNorm backward, K5 and K6. K5 and K6 have a limit of
their own, ``K56_TC_MAX_HEAD_DIM`` (256; ``flash_graph_attention.k56_path``):
their tensor-core kernels take bfloat16 at multiples of 16 up to 256 and
their register-tiled kernels float32 at multiples of 4 up to 256 (pairs of
warps above 128). K1 and K4 have theirs, ``K14_TC_MAX_HEAD_DIM`` (256;
``fused_graph_attention.k1_path`` and ``flash_graph_attention.k4_path``):
K1's tensor-core kernel takes bfloat16 at multiples of 16 up to 256, K4's
tensor-core kernel bfloat16 at every multiple of 16 (above 256 in chunks of
256 output channels) and its register-tiled kernel float32 at multiples of
4 up to 256; K1 in float32 keeps 128. Every other call keeps the first SIMT
kernels, up to
``SIMT_MAX_HEAD_DIM``. Wider heads take the wide kernels ("wide"), which
cut a head's output channels into chunks of 256 over blocks. No kernel has
an upper bound on C or on the head width.
"""

from __future__ import annotations

import torch

SM_COUNT = 132       # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
TC_MAX_HEAD_DIM = 128   # K2's tensor-core and register-tiled f32 kernels' widest head (K1's
                        # f32 kernel's too)
K14_TC_MAX_HEAD_DIM = 256   # K1's tensor-core kernel's widest head, and K4's tensor-core
                            # (unchunked) and register-tiled f32 kernels'
K56_TC_MAX_HEAD_DIM = 256   # K5's and K6's tensor-core and register-tiled f32 kernels' widest
                            # head (instance 256: pairs of warps)
SIMT_MAX_HEAD_DIM = 256  # the first SIMT kernels' widest head (register accumulators);
                         # wider heads take the wide kernels
TC_WIDTHS = (16, 32, 64, 128, 256)   # the instances of K1's and K4's tensor-core kernels
                                     # (head widths; csrc/graph_attention.cu:launch_tc_dh,
                                     # csrc/flash_graph_attention.cu:launch_tc_dh)


def tc_width(head_dim: int) -> int:
    """The instance of K1's or K4's tensor-core kernel a head width runs in
    (its upper channels staged as zeros)."""
    return next(w for w in TC_WIDTHS if head_dim <= w)


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises for any other
    device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def kernel_path(dtype, head_dim: int) -> str:
    """Which of its CUDA kernels K2 takes: ``"tensor-core"`` (``mma.sync``
    on bf16 tiles) for bfloat16 with a head width that is a multiple of 16
    up to ``TC_MAX_HEAD_DIM``, else ``"simt"`` (f32 FMAs on the CUDA cores,
    in float32 the register-tiled kernels named above where they take the
    width): TF32 products would not hold the 1e-4 the float32 path is
    checked to. K1, K4, K5 and K6 take their own limits
    (``K14_TC_MAX_HEAD_DIM``, ``K56_TC_MAX_HEAD_DIM``; ``k1_path``,
    ``k4_path``, ``k56_path``)."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= TC_MAX_HEAD_DIM:
        return "tensor-core"
    return "simt"


def f32_tiled(dtype, head_dim: int) -> bool:
    """Whether a float32 call of K1 or K2 takes their register-tiled FFMA
    kernels (``csrc/simt_f32.cuh``): a head width that is a multiple of 4
    up to ``TC_MAX_HEAD_DIM`` (K4's, K5's and K6's reach 256)."""
    return dtype == torch.float32 and head_dim % 4 == 0 and head_dim <= TC_MAX_HEAD_DIM


def composite_backward(fn, ctx, grad_out):
    """Autograd of ``fn`` on the saved inputs, for those that need a
    gradient (the backward pass of an entry whose forward is a kernel)."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = fn(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
