"""K5's float32 kernel by key split, timed through its C entry.

The C entry takes the plan (query rows a block, shards, steps a shard) as
arguments, so one build times every plan: each is called through ctypes on
the same inputs, without the Python wrapper, and the wrapper's own call is
timed beside the plan it picks (``dq_f32_plan``), which shows the host's
share of a short call.

    python3 scripts/k5_f32_variants.py         # needs an H100 and nvcc (~1 min)

Prints the card and, per shape and plan: the device time of one call (its
kernels' durations under torch.profiler over 20 calls, the shard sum
included), the time per call back to back (mean of 50 after 5 warm-ups,
CUDA events) and the largest difference from the unsplit call's dQ over its
largest magnitude (0 where the bits are the same).
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import _build  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl  # noqa: E402

HEADS = 8
# (label, Tq, Tk) at B 4, 8 heads of 64: the decoder's one query, the odd
# shape and two query tiles (split by the plan), the encoder (not split)
SHAPES = (("cross Tq=1 Lk=1536", 1, 1536), ("odd Tq=200 Tk=700", 200, 700),
          ("split Tq=70 Tk=1536", 70, 1536), ("self L=1536", 1536, 1536))
STEPS_A_SHARD = (1, 2, 4, 8, 16)


def inputs(gen, label: str, tq: int, tk: int) -> tuple:
    """K5's arguments (l1), with K4's statistics of chip_smoke's inputs."""
    q, k, v, key_mask, query_mask, graph = cs.flash_inputs(gen, label, tq, tk, torch.float32)
    dy = torch.randn(q.shape, generator=gen, device="cuda")
    out, m, z, bsum = fl.flash_graph_attention(q, k, v, key_mask, query_mask, graph, HEADS, "l1",
                                               "stats")
    d_out, delta = fl.masked_grad_and_delta(out, dy, query_mask, HEADS)
    return q, k, v, key_mask, graph, m, z, bsum, delta, d_out


def device_ms(call, n: int = 20) -> float:
    """Mean device time of one call: its kernels' durations, profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / n / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_f32_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    fn = _build.library("flash_graph_attention_bwd").savqa_flash_graph_attention_bwd_dq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dh = cs.C // HEADS
    for label, tq, tk in SHAPES:
        args = inputs(gen, label, tq, tk)
        b = args[0].shape[0]
        pointers = [a.data_ptr() for a in args]
        steps = -(-tk // fl.DQ_F32_STEP)
        stream = torch.cuda.current_stream().cuda_stream
        want = None
        plans = [(16 if tq <= 16 else 64, 1, steps)]
        plans += [(plans[0][0], -(-steps // per), per) for per in STEPS_A_SHARD if per < steps]
        if tq <= 16:
            plans += [(64, -(-steps // per), per) for per in (4, steps)]
        for q_tile, n_split, per in plans:
            dq = torch.empty_like(args[0])
            scratch = torch.empty(n_split, *dq.shape, device="cuda") if n_split > 1 else None

            def call():
                _build.check(fn(*pointers, dq.data_ptr(),
                                None if scratch is None else scratch.data_ptr(), b, tq, tk, cs.C,
                                HEADS, 0, 0, fl.DQ_PATHS.index("f32"), q_tile, n_split, per,
                                1.0 / dh ** 0.5, stream), "K5 f32")

            call()
            torch.cuda.synchronize()
            if want is None:
                want = dq.clone()
            diff = cs.rel_err(dq, want)
            mine = (q_tile, n_split, per) == fl.dq_f32_plan(b, HEADS, tq, tk)
            print(f"K5 f32 {label}: {q_tile} rows a block, {n_split} shard(s) of {per} step(s)"
                  f"{' (the plan)' if mine else ''}: device {device_ms(call):.4f} ms, back to back "
                  f"{cs.time_ms(call, iters=50, warmup=5):.4f} ms a call, max|dq - unsplit| / "
                  f"max|unsplit| {diff:.3g}", flush=True)
        wrapper = lambda: fl.flash_bwd_dq(*args, HEADS, "l1")
        print(f"K5 f32 {label}: through the wrapper: device {device_ms(wrapper):.4f} ms, back to "
              f"back {cs.time_ms(wrapper, iters=50, warmup=5):.4f} ms a call", flush=True)
        del args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
