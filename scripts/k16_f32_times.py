"""K1 and K6 in float32 on the card, at every shape the port gives them, the
two f32 training steps and the x2_dec f32 request, through the package
found under ``--root``.

The training CLI computes in float32 unless ``--bf16`` is given, and the 17
variants serve in float32, so these are the calls its users wait on. Run
it on two trees in one call to compare them on one card: each line names
the tree's root.

    python3 scripts/k16_f32_times.py                     # this checkout
    python3 scripts/k16_f32_times.py --root build/parent # another tree's package

Prints the card's name and power limit, then per shape: ms per call through
the wrapper (mean of 20 after 3 warm-ups, CUDA events), the bound (bytes
or FFMA operations at 3.35 TB/s and 67 TFLOP/s) and the largest error
against the plain version relative to its largest magnitude; K1 through its
full entry (attention, residual and LayerNorm) at the obj-only,
obj+rel-visual and variants' shapes and through its attention-only entry on
a model rank's 4 heads, K6 at the obj+rel point, its one-query and odd
shapes, the ring's 768 x 768 shard and 4 heads; then, unless
``--no-steps``, the obj-only f32 training step at bs 128 and the obj+rel
one at bs 4 (steps/s over 5 steps, device time by kernel and idle share of
one under torch.profiler) and one x2_dec f32 request at the variant eval
CLI's defaults (device time by kernel).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

# K1: (label, Tq, Tk, batch, heads, the full entry or the attention-only one)
K1_SHAPES = (("self L=128", 128, 128, 128, 8, True), ("self L=66", 66, 66, 128, 8, True),
             ("cross Tq=1 Lk=128", 1, 128, 128, 8, True),
             ("cross Tq=1 Lk=66", 1, 66, 128, 8, True),
             ("self L=66 B=4", 66, 66, 4, 8, True), ("cross Tq=1 Lk=66 B=4", 1, 66, 4, 8, True),
             ("self L=99 B=64", 99, 99, 64, 8, True), ("self L=300 B=64", 300, 300, 64, 8, True),
             ("cross Tq=1 Lk=99 B=64", 1, 99, 64, 8, True),
             ("cross Tq=1 Lk=300 B=64", 1, 300, 64, 8, True),
             ("x5 Tq=50 Lk=299 B=64", 50, 299, 64, 8, True),
             ("heads entry L=128 4 heads", 128, 128, 128, 4, False))
# K6: (label, Tq, Tk, heads); the ring's shard is one rank's 768 queries
# against a 768-key block (chip_smoke.py phase seq), 4 heads of 64 a model
# rank's (phase model)
K6_SHAPES = (("self L=1536", 1536, 1536, 8), ("self L=1506+30", 1536, 1536, 8),
             ("cross Tq=1 Lk=1536", 1, 1536, 8), ("odd Tq=200 Tk=700", 200, 700, 8),
             ("ring shard Tq=768 Tk=768", 768, 768, 8), ("self L=1536 4 heads", 1536, 1536, 4))


def main(argv: list) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(HERE), help="the tree whose package is timed")
    parser.add_argument("--no-steps", action="store_true", help="kernels only")
    parser.add_argument("--steps-only", action="store_true",
                        help="the two steps and the x2_dec request only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k16_f32_times: no CUDA device is available", file=sys.stderr)
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
    gen = torch.Generator(device="cuda").manual_seed(17)

    for label, tq, tk, b, heads, full in () if args.steps_only else K1_SHAPES:
        a = cs.k1_inputs(gen, tq, tk, dtype, b)
        width = c * heads // cs.HEADS
        if full:
            call = lambda: k1.fused_graph_attention_ln(*a, heads, "l1")
            plain = k1.graph_attention_ln_plain(*a, heads, "l1")
            # reads q, k, v, residual, the masks, the graph, gamma, beta; writes out
            nbytes = 4 * b * c * (3 * tq + 2 * tk) + 4 * b * (tq + tk + tq * tk) + 8 * c
        else:
            a = tuple(t[..., :width].contiguous() for t in a[:3]) + a[3:6]
            call = lambda: k1.graph_attention_heads(*a, heads, "l1")
            plain = k1.graph_attention_plain(*a, heads, "l1")
            # reads q, k, v, the masks and the graph; writes o
            nbytes = 4 * b * width * (2 * tq + 2 * tk) + 4 * b * (tq + tk + tq * tk)
        err = cs.rel_err(call(), plain)
        ms = cs.time_ms(call)
        bound_ms, by = cs.bound(nbytes, 4.0 * b * tq * tk * width, dtype)
        print(f"K1 f32 {label}: {ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), "
              f"max|kernel-plain|/max|plain| {err:.3g}", flush=True)
        del a, plain
        torch.cuda.empty_cache()

    for label, tq, tk, heads in () if args.steps_only else K6_SHAPES:
        q, k, v, key_mask, query_mask, graph = cs.flash_inputs(gen, label.split(" 4")[0], tq, tk,
                                                               dtype)
        width = c * heads // cs.HEADS
        q, k, v = (t[..., :width].contiguous() for t in (q, k, v))
        b = q.shape[0]
        dy = torch.randn(b, tq, width, generator=gen, device="cuda")
        out, m, z, bsum = fl.flash_graph_attention(q, k, v, key_mask, query_mask, graph, heads,
                                                   "l1", "stats")
        d_out, delta = fl.masked_grad_and_delta(out, dy, query_mask, heads)
        bwd = (q, k, v, key_mask, graph, m, z, bsum, delta, d_out, heads, "l1")
        err = max(cs.rel_err(g, w) for g, w in zip(fl.flash_bwd_dkv(*bwd),
                                                     fl.flash_bwd_dkv_plain(*bwd)))
        ms = cs.time_ms(lambda: fl.flash_bwd_dkv(*bwd))
        # reads q, dO (Tq), k, v (Tk), the graph, the masks and the rows'
        # m, z, b, delta; writes dk and dv (Tk); four products of 2 B Tq Tk C
        nbytes = 4 * b * width * (2 * tq + 4 * tk) + 4 * b * (tq * tk + tk + 4 * heads * tq)
        bound_ms, by = cs.bound(nbytes, 8.0 * b * tq * tk * width, dtype)
        print(f"K6 f32 {label}: {ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), "
              f"max|kernel-plain|/max|plain| {err:.3g}", flush=True)
        del q, k, v, graph, bwd
        torch.cuda.empty_cache()

    if not args.no_steps:
        cfg = cs.full_config(compute_dtype=torch.float32)
        cs.f32_step_profile(cfg, cs.full_batches(cfg, cs.TRAIN_STEPS), cs.B, "obj-only", "card")
        cfg = cs.rel_config(compute_dtype=torch.float32)
        cs.f32_step_profile(cfg, cs.rel_batches(cfg, cs.TRAIN_STEPS), cs.REL_B, "obj+rel", "card")
        from structured_alignment_vqa_tpu_torch.models import init_random_
        from structured_alignment_vqa_tpu_torch.models.variants import build_variant

        model = build_variant("x2_dec", cs.variant_config("x2_dec"))
        init_random_(model, torch.Generator(device="cuda").manual_seed(3))
        model.eval()
        inputs = cs.variant_inputs("x2_dec", 3)
        with torch.inference_mode():
            model(*inputs)          # warm-up: cuBLAS handles, allocator
            cs.profile_device(lambda: model(*inputs),
                              f"one bs-{inputs[0].shape[0]} x2_dec f32 request")
    return 1 if cs.failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
