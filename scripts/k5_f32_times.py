"""K5 in float32 on the card, at every shape the port gives it, the obj+rel
f32 training step and an x3_ori f32 request and backward, through the
package found under ``--root``.

The training CLI computes in float32 unless ``--bf16`` is given, so the
obj+rel f32 step is what its users wait on in that configuration. Run it on
two trees in one call to compare them on one card: each line names the
tree's root.

    python3 scripts/k5_f32_times.py                     # this checkout
    python3 scripts/k5_f32_times.py --root build/parent # another tree's package

Prints the card's name and power limit, then per shape: the kernel and key
shards the call takes (where the tree says), ms per call through the
wrapper (mean of 20 after 3 warm-ups, CUDA events), the plain version's ms
(mean of 5), the bound (bytes or FFMA operations at 3.35 TB/s and 67
TFLOP/s) and the largest error against the plain version relative to its
largest magnitude: the obj+rel point (B 4, L 1,536 and its 1,506 + 30
masks), the decoder's one query into 1,536 keys, 200 queries into 700 keys,
the ring's 768 x 768 rotation and a model rank's 4 heads of 64. Then,
unless ``--no-steps``, the obj+rel f32 training step at bs 4 (steps/s over
5 steps, device time by kernel and idle share of one under torch.profiler)
and one x3_ori f32 request and one x3_ori f32 forward and backward at the
obj+rel point (device time by kernel).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

# (label, Tq, Tk, heads) at B 4, 64 channels a head; the ring's rotation is
# one rank's 768 queries against a 768-key block (chip_smoke.py phase seq),
# 4 heads a model rank's (phase model)
SHAPES = (("self L=1536", 1536, 1536, 8), ("self L=1506+30", 1536, 1536, 8),
          ("cross Tq=1 Lk=1536", 1, 1536, 8), ("odd Tq=200 Tk=700", 200, 700, 8),
          ("ring shard Tq=768 Tk=768", 768, 768, 8), ("self L=1536 4 heads", 1536, 1536, 4))


def plan_of(fl, b: int, heads: int, tq: int, tk: int) -> str:
    """The kernel and key shards a float32 call takes, where the tree says."""
    if not hasattr(fl, "dq_f32_plan"):
        return "the first SIMT kernel, 1 key shard"
    q_tile, n_split, per = fl.dq_f32_plan(b, heads, tq, tk)
    return f"f32 kernel, {q_tile} rows a block, {n_split} key shard(s) of {per} step(s)"


def x3_ori_profiles(cs) -> None:
    """One x3_ori f32 request, then one forward and backward of its
    label-smoothed CE, each under torch.profiler."""
    from structured_alignment_vqa_tpu_torch.models import init_random_
    from structured_alignment_vqa_tpu_torch.models.variants import build_variant

    model = build_variant("x3_ori", cs.variant_config("x3_ori"))
    init_random_(model, torch.Generator(device="cuda").manual_seed(3))
    inputs = cs.variant_inputs("x3_ori", 3)
    model.eval()
    with torch.inference_mode():
        model(*inputs)          # warm-up: cuBLAS handles, allocator
        cs.profile_device(lambda: model(*inputs),
                          f"one bs-{inputs[0].shape[0]} x3_ori f32 request")
    answer = torch.zeros(inputs[0].shape[0], dtype=torch.long, device="cuda")
    loss_fn = cs.variant_loss("x3_ori", inputs, answer)

    def backward():
        model.zero_grad(set_to_none=True)
        loss_fn(model(*inputs)).backward()

    backward()                  # warm-up
    cs.profile_device(backward, f"one bs-{inputs[0].shape[0]} x3_ori f32 forward and backward")
    del model
    torch.cuda.empty_cache()


def main(argv: list) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(HERE), help="the tree whose package is timed")
    parser.add_argument("--no-steps", action="store_true", help="kernels only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_f32_times: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this checkout's chip_smoke.py (its helpers), whatever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from structured_alignment_vqa_tpu_torch.ops import _build
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl

    if not fl.__file__.startswith(root):
        raise SystemExit(f"the package came from {fl.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}; tree {root}", flush=True)
    _build.build_all()
    dtype, c = torch.float32, cs.C
    gen = torch.Generator(device="cuda").manual_seed(18)

    for label, tq, tk, heads in SHAPES:
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
        err = cs.rel_err(fl.flash_bwd_dq(*bwd), fl.flash_bwd_dq_plain(*bwd))
        ms = cs.time_ms(lambda: fl.flash_bwd_dq(*bwd))
        plain_ms = cs.time_ms(lambda: fl.flash_bwd_dq_plain(*bwd), iters=5)
        # reads q, dO (Tq), k, v (Tk), the graph, the key mask and the rows'
        # m, z, b, delta; writes dq (Tq); three products of 2 B Tq Tk C
        nbytes = 4 * b * width * (3 * tq + 2 * tk) + 4 * b * (tq * tk + tk + 4 * heads * tq)
        bound_ms, by = cs.bound(nbytes, 6.0 * b * tq * tk * width, dtype)
        print(f"K5 f32 {label}: {plan_of(fl, b, heads, tq, tk)}, {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), "
              f"max|kernel-plain|/max|plain| {err:.3g}", flush=True)
        del q, k, v, graph, bwd
        torch.cuda.empty_cache()

    if not args.no_steps:
        cfg = cs.rel_config(compute_dtype=torch.float32)
        cs.f32_step_profile(cfg, cs.rel_batches(cfg, cs.TRAIN_STEPS), cs.REL_B, "obj+rel", "card")
        x3_ori_profiles(cs)
    return 1 if cs.failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
