"""Which version of a kernel a wrapper runs.

A wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors; there is no switch between the two. A launch
that fails raises: nothing falls back to the plain version. K1, K2, K4's
forward and its backward K5 and K6 each have two CUDA kernels, and
:func:`kernel_path` says which one a call takes: the tensor cores for
bfloat16 at head widths that are multiples of 16, else the CUDA cores
("simt"). On the CUDA cores K1, K2, K4, K5 and K6 in float32 run
register-tiled FFMA kernels (``csrc/simt_f32.cuh``) at head widths that are
multiples of 4 up to 128 (``fused_graph_attention.k1_path`` and
``k2_path``, ``flash_graph_attention.k4_path``, ``dq_kernel`` and
``dkv_kernel``). Every other call keeps the first SIMT kernels: bfloat16 at
a head width that is no multiple of 16 or above ``TC_MAX_HEAD_DIM``,
float32 at a head width that is no multiple of 4 or above it, up to
``SIMT_MAX_HEAD_DIM``. Wider heads take the wide kernels ("wide"), which
cut a head's output channels into chunks of 256 over blocks. No kernel has
an upper bound on C or on the head width.
"""

from __future__ import annotations

import torch

SM_COUNT = 132       # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
TC_MAX_HEAD_DIM = 128   # the tensor-core and register-tiled f32 kernels' widest head
SIMT_MAX_HEAD_DIM = 256  # the first SIMT kernels' widest head (register accumulators);
                         # wider heads take the wide kernels


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises for any other
    device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def kernel_path(dtype, head_dim: int) -> str:
    """Which of its CUDA kernels K1, K2, K4, K5 or K6 takes: ``"tensor-core"``
    (``mma.sync`` on bf16 tiles) for bfloat16 with a head width that is a
    multiple of 16 up to ``TC_MAX_HEAD_DIM``, else ``"simt"`` (f32 FMAs on
    the CUDA cores, in float32 the register-tiled kernels named above where
    they take the width): TF32 products would not hold the 1e-4 the float32
    path is checked to."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= TC_MAX_HEAD_DIM:
        return "tensor-core"
    return "simt"


def f32_tiled(dtype, head_dim: int) -> bool:
    """Whether a float32 call takes the register-tiled FFMA kernels
    (``csrc/simt_f32.cuh``): a head width that is a multiple of 4 up to
    ``TC_MAX_HEAD_DIM``."""
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
