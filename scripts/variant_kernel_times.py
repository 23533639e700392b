"""K1, K3 and K4 alone at the shapes the ablation variants give them, on the
card: each kernel against its plain version, its mean time over 20 calls
after 3 warm-ups (CUDA events), the plain version's time and its bound;
for K4 at x3_ori's self-attention also ``scaled_dot_product_attention``
in f32 as the library's time. The variants compute in float32, as their
eval CLI does (``train/evaluate_variants.py``, bs 64, hidden 512, 8 heads).

    python3 scripts/variant_kernel_times.py     # ~40 s with the build, one card

Shapes (``chip_smoke.py`` phase ``variants``): K1 at B 64 self L 99 and
300, one query into 99 and 300, 50 queries into 299 (x5's); K3 at 64,
3,136, 6,336 and 19,200 rows of 512 (a decoder token, 49 regions, 99 and
300 tokens a sample) and at 3,136 rows of 2,048 (x2_fusion_dec_mil2's
alignment FFN over 49 regions); K4 at x3_ori's B 4, self L 1,536 and one
query into 1,536. The card's name and power limit come first, then
ptxas's registers and spills of K3's kernels.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

VARIANT_B = 64
K1_SHAPES = (("self L=99", 99, 99), ("self L=300", 300, 300), ("cross Tq=1 Lk=99", 1, 99),
             ("cross Tq=1 Lk=300", 1, 300), ("cross Tq=50 Lk=299 (x5)", 50, 299))
K3_SHAPES = ((64, 512), (3136, 512), (6336, 512), (19200, 512), (3136, 2048))   # (rows, C)
K4_SHAPES = (("self L=1536", cs.REL_L, cs.REL_L), ("cross Tq=1 Lk=1536", 1, cs.REL_L))


def main() -> int:
    if not torch.cuda.is_available():
        print("variant_kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    from structured_alignment_vqa_tpu_torch.ops import _build
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl
    from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build_all()
    for line in _build.register_lines(_build.build_log("ffn")):
        print(f"  ffn: {line}", flush=True)
    dtype, size = torch.float32, 4
    gen = torch.Generator(device="cuda").manual_seed(21)
    c, heads = cs.C, cs.HEADS

    for label, tq, tk in K1_SHAPES:
        args = cs.k1_inputs(gen, tq, tk, dtype, VARIANT_B)
        err = cs.k1_against_plain(label, args, heads)
        ms = cs.time_ms(lambda: k1.fused_graph_attention_ln(*args, heads, "l1"))
        plain_ms = cs.time_ms(lambda: k1.graph_attention_ln_plain(*args, heads, "l1"))
        nbytes = size * VARIANT_B * c * (3 * tq + 2 * tk) + 4 * VARIANT_B * (tq + tk + tq * tk) \
            + 8 * c
        bound_ms, by = cs.bound(nbytes, 4.0 * VARIANT_B * tq * tk * c, dtype)
        print(f"K1 f32 B={VARIANT_B} {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.2f} us ({by}), max|kernel-plain| {err:.3g}; library: none",
              flush=True)

    for rows, width in K3_SHAPES:
        a = cs.k3_inputs(gen, rows, width, dtype)
        hidden = 4 * width
        err = (k3.fused_ffn(*a) - k3.ffn_ln_plain(*a)).abs().max().item()
        label = f"rows={rows}" if width == c else f"rows={rows} C={width}"
        cs.check(err <= cs.TOL[dtype], f"K3 f32 {label}: max|kernel-plain| {err:.3g}")
        ms = cs.time_ms(lambda: k3.fused_ffn(*a))
        plain_ms = cs.time_ms(lambda: k3.ffn_ln_plain(*a))
        nbytes = size * (2 * rows * width + 2 * width * hidden + hidden + width) + 8 * width
        bound_ms, by = cs.bound(nbytes, 4.0 * rows * width * hidden, dtype)
        n_split = k3.kernel_ffn_split(dtype, rows, width, hidden)[0]
        print(f"K3 f32 {label}: {cs.k3_path(dtype, rows, width)}, {n_split} shard(s), "
              f"{ms:.4f} ms{cs.previous('K3', label, dtype)}, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.2f} us ({by}); library: none", flush=True)

    for label, tq, tk in K4_SHAPES:
        args = cs.flash_inputs(gen, label, tq, tk, dtype)
        err = cs.k4_against_plain(label, args, heads)
        ms = cs.time_ms(lambda: fl.flash_graph_attention(*args, heads, "l1"))
        plain_ms = cs.time_ms(lambda: fl.flash_graph_attention_plain(*args, heads, "l1"), iters=5)
        nbytes = size * cs.REL_B * c * (2 * tq + 2 * tk) + 4 * cs.REL_B * (tq * tk + tq + tk)
        bound_ms, by = cs.bound(nbytes, 4.0 * cs.REL_B * tq * tk * c, dtype)
        library_ms, library_err = cs.sdpa_yardstick(args)
        print(f"K4 f32 B={cs.REL_B} {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.2f} us ({by}), max|kernel-plain| {err:.3g}; library: SDPA f32 "
              f"with the graph as a boolean mask {library_ms:.4f} ms (max|K4 - SDPA| on rows "
              f"with a neighbour {library_err:.3g})", flush=True)
    if cs.failures:
        print(f"variant_kernel_times: {len(cs.failures)} check(s) failed", file=sys.stderr)
        return 1
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
