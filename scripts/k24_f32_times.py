"""K2 and K4 in float32 on the card, at every shape the port gives them, and
the two f32 training steps, through the package found under ``--root``.

The training CLI computes in float32 unless ``--bf16`` is given, and the 17
variants serve in float32, so these are the calls its users wait on. Run
it on two trees in one call to compare them on one card: each line names
the tree's root.

    python3 scripts/k24_f32_times.py                     # this checkout
    python3 scripts/k24_f32_times.py --root build/parent # another tree's package

Prints the card's name and power limit, then per shape: ms per call through
the wrapper (mean of 20 after 3 warm-ups, CUDA events), the bound (bytes
or FFMA operations at 3.35 TB/s and 67 TFLOP/s), for K4 the time of
``scaled_dot_product_attention`` with the graph as a boolean mask, and the
largest error against the plain version relative to its largest
magnitude; then, unless ``--no-steps``, the obj-only f32 training step at
bs 128 and the obj+rel one at bs 4: steps/s over 5 steps and the device
time by kernel and idle share of one (torch.profiler), with ``--host N``
also the N ops that took the most host time themselves (``--steps-only``:
the steps alone).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

# K4: (label, Tq, Tk, heads, emit); the ring's shard is one rank's 768
# queries against a 768-key block (chip_smoke.py phase seq); 4 heads of 64
# are a model rank's (phase model)
K4_SHAPES = (("self L=1536", 1536, 1536, 8, "out"), ("cross Tq=1 Lk=1536", 1, 1536, 8, "out"),
             ("odd Tq=200 Tk=700", 200, 700, 8, "out"),
             ("split Tq=70 Tk=1536", 70, 1536, 8, "out"),
             ("self L=1536 4 heads", 1536, 1536, 4, "out"),
             ("ring shard Tq=768 Tk=768", 768, 768, 8, "partial"))
# K2: (label, Tq, Tk, batch, heads, from d(o))
K2_SHAPES = (("self L=128", 128, 128, 128, 8, False), ("self L=66", 66, 66, 128, 8, False),
             ("cross Tq=1 Lk=128", 1, 128, 128, 8, False),
             ("cross Tq=1 Lk=66", 1, 66, 128, 8, False),
             ("self L=66 B=4", 66, 66, 4, 8, False), ("cross Tq=1 Lk=66 B=4", 1, 66, 4, 8, False),
             ("self L=99 B=64", 99, 99, 64, 8, False), ("self L=300 B=64", 300, 300, 64, 8, False),
             ("cross Tq=1 Lk=99 B=64", 1, 99, 64, 8, False),
             ("cross Tq=1 Lk=300 B=64", 1, 300, 64, 8, False),
             ("from d(o) L=128 4 heads", 128, 128, 128, 4, True))


def main(argv: list) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(HERE), help="the tree whose package is timed")
    parser.add_argument("--no-steps", action="store_true", help="kernels only")
    parser.add_argument("--host", type=int, default=0,
                        help="also the N ops that took the most host time in each profiled step")
    parser.add_argument("--steps-only", action="store_true", help="the two steps only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k24_f32_times: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this checkout's chip_smoke.py (its helpers), whatever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from structured_alignment_vqa_tpu_torch.ops import _build
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    if not fl.__file__.startswith(root):
        raise SystemExit(f"the package came from {fl.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}; tree {root}", flush=True)
    _build.build_all()
    dtype, c = torch.float32, cs.C
    gen = torch.Generator(device="cuda").manual_seed(16)

    for label, tq, tk, heads, emit in () if args.steps_only else K4_SHAPES:
        q, k, v, key_mask, query_mask, graph = cs.flash_inputs(gen, label.split(" 4")[0], tq, tk,
                                                               dtype)
        width = c * heads // cs.HEADS
        q, k, v = (t[..., :width].contiguous() for t in (q, k, v))
        a = (q, k, v, key_mask, query_mask, graph)
        got = fl.flash_graph_attention(*a, heads, "l1", emit)
        want = fl.flash_graph_attention_plain(*a, heads, "l1", emit)
        got, want = (got,) if torch.is_tensor(got) else got, \
            (want,) if torch.is_tensor(want) else want
        err = max(cs.rel_err(g, w) for g, w in zip(got, want))
        ms = cs.time_ms(lambda: fl.flash_graph_attention(*a, heads, "l1", emit))
        b = q.shape[0]
        nbytes = 4 * b * width * (2 * tq + 2 * tk) + 4 * b * (tq * tk + tq + tk)
        bound_ms, by = cs.bound(nbytes, 4.0 * b * tq * tk * width, dtype)
        lib = "none (SDPA gives no m, z, b)"
        if emit == "out":
            lib = f"SDPA {cs.sdpa_yardstick(a, heads)[0]:.4f} ms"
        print(f"K4 f32 {label}: {ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), {lib}, "
              f"max|kernel-plain|/max|plain| {err:.3g}", flush=True)
        del a, q, k, v, graph
        torch.cuda.empty_cache()

    for label, tq, tk, b, heads, from_do in () if args.steps_only else K2_SHAPES:
        a, dy = cs.k2_inputs(gen, tq, tk, dtype, b)
        width = c * heads // cs.HEADS
        if from_do:
            a = tuple(t[..., :width].contiguous() for t in a[:3]) + a[3:6]
            dy = dy[..., :width].contiguous()
            call = lambda: k1.graph_attention_heads_bwd(*a, dy, heads, "l1")
            plain = k1.graph_attention_bwd_plain(*a, dy, heads, "l1")
            # reads q, k, v, dO, the masks and the graph; writes dq, dk, dv
            nbytes = 4 * b * width * (4 * tq + 3 * tk) + 4 * b * (tq + tk + tq * tk)
            ops = 10.0 * b * tq * tk * width
        else:
            call = lambda: k1.fused_graph_attention_ln_bwd(*a, dy, heads, "l1")
            plain = k1.graph_attention_ln_bwd_plain(*a, dy, heads, "l1")
            nbytes = 4 * b * width * (5 * tq + 4 * tk) + 4 * b * (tq + tk + tq * tk) + 12 * width
            ops = 12.0 * b * tq * tk * width
        err = max(cs.rel_err(g, w) for g, w in zip(call(), plain))
        ms = cs.time_ms(call)
        bound_ms, by = cs.bound(nbytes, ops, dtype)
        print(f"K2 f32 {label}: {ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), "
              f"max|kernel-plain|/max|plain| {err:.3g}", flush=True)
        del a, dy, plain
        torch.cuda.empty_cache()

    if not args.no_steps:
        cfg = cs.full_config(compute_dtype=torch.float32)
        cs.f32_step_profile(cfg, cs.full_batches(cfg, cs.TRAIN_STEPS), cs.B, "obj-only", "card",
                            args.host)
        cfg = cs.rel_config(compute_dtype=torch.float32)
        cs.f32_step_profile(cfg, cs.rel_batches(cfg, cs.TRAIN_STEPS), cs.REL_B, "obj+rel", "card",
                            args.host)
    return 1 if cs.failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
