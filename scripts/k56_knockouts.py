"""Where K5's and K6's tensor-core kernels spend their time, by knock-out.

The counterpart of ``scripts/k4_knockouts.py`` for the flash backward: it
times copies of ``csrc/flash_graph_attention_bwd.cu`` with one part of the
bf16 kernels removed; the difference to the unchanged source is what that
part costs while everything else goes on. The copies compute garbage; only
their times mean anything. Each copy is built by nvcc into
``build/knockouts_k56/`` (all at once) and its two C entry points are
called through ctypes on the same inputs, so the times are of the kernels
alone (K5's key split and its sum kernel included), without the Python
wrappers' allocations and checks.

    python3 scripts/k56_knockouts.py            # needs an H100 and nvcc

Prints the card and, per shape, kernel and variant, ms per call (mean of 50
after 5 warm-ups, CUDA events), the unchanged source first and last.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from structured_alignment_vqa_tpu_torch.ops import _build  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl  # noqa: E402

B, C, HEADS = 4, 512, 8
SHAPES = (("self L=1536", 1536, 1536), ("cross Tq=1 Lk=1536", 1, 1536))

# variant -> (text in the source, what replaces it); every text must occur once
EXP = "const float e = fast_exp2(keep ? fmaf(raw, scale2, -t.m2) : t.fill2);"
VARIANTS = {
    "base": [],
    # K6: no copies after the first step's (products and dS alone)
    "k6_no_loads": [("    if (more) load_step(step + 1);\n", "")],
    # K6: the graph entries are not read from the staged tile
    "k6_no_graph_reads": [("g_col[r * kLdG], keep_a", "1.f, keep_a"),
                          ("g_col[r * kLdG + 8], keep_b", "1.f, keep_b")],
    # K6: every entry reads the terms of row 0 (one broadcast read, hoisted)
    "k6_no_terms_reads": [("const TcRowTerms rt = terms[r];", "const TcRowTerms rt = terms[0];")],
    # K6: two blocks an SM (registers capped at 255, not 168) and the rows of a
    # step in two halves of 32, not four quarters of 16
    "k6_two_blocks_an_sm": [("constexpr int kDkvBlocks = 3;", "constexpr int kDkvBlocks = 2;")],
    "k6_half_steps_two_blocks": [("constexpr int kDkvBlocks = 3;", "constexpr int kDkvBlocks = 2;"),
                                 ("constexpr int kDkvSub = kTile / 4;",
                                  "constexpr int kDkvSub = kTile / 2;")],
    # K5: two blocks an SM (registers capped at 255, not 168) and the keys of a
    # step in one pass, not two halves of 32; then four quarters of 16
    "k5_two_blocks_an_sm": [("constexpr int kDqBlocks = 3;", "constexpr int kDqBlocks = 2;")],
    "k5_full_steps_two_blocks": [("constexpr int kDqBlocks = 3;", "constexpr int kDqBlocks = 2;"),
                                 ("constexpr int kDqSub = kTile / 2;", "constexpr int kDqSub = kTile;")],
    "k5_quarter_steps": [("constexpr int kDqSub = kTile / 2;", "constexpr int kDqSub = kTile / 4;")],
    # K5: no copies after the first step's
    "k5_no_loads": [("    if (step + 1 < step_hi) load_step(step + 1);\n", "")],
    # K5: the graph entries are not read from the staged tile
    "k5_no_graph_reads": [
        ("const float2 ga = *reinterpret_cast<const float2*>(g_a + jl);",
         "const float2 ga = make_float2(1.f, 1.f);"),
        ("const float2 gbv = *reinterpret_cast<const float2*>(g_b + jl);",
         "const float2 gbv = make_float2(1.f, 1.f);")],
    # both: the exponential becomes its argument
    "no_exp": [(EXP, EXP.replace("fast_exp2", ""))],
    "base_again": [],
}


def build() -> dict:
    out_dir = _build.BUILD_DIR / "knockouts_k56"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC_DIR / "flash_graph_attention_bwd.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: expected one occurrence of {old!r} in the source")
            text = text.replace(old, new)
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        (lib.with_suffix(".log")).write_text(log)   # ptxas: registers and spills
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def inputs(gen, tq: int, tk: int) -> tuple:
    """The backward's arguments (l1), with K4's statistics of the inputs."""
    q, k, v = (torch.randn(B, t, C, generator=gen, device="cuda").relu().bfloat16()
               for t in (tq, tk, tk))
    key_mask = torch.ones(B, tk, device="cuda")
    key_mask[1, tk - 100:] = 0.0
    query_mask = torch.ones(B, tq, device="cuda")
    graph = (torch.rand(B, tq, tk, generator=gen, device="cuda") < 0.3).float()
    dy = torch.randn(B, tq, C, generator=gen, device="cuda").bfloat16()
    out, m, z, bsum = fl.flash_graph_attention(q, k, v, key_mask, query_mask, graph, HEADS, "l1",
                                               "stats")
    d_out, delta = fl.masked_grad_and_delta(out, dy, query_mask, HEADS)
    return q, k, v, key_mask, graph, m, z, bsum, delta, d_out


def timed(call) -> float:
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 50


def time_entries(lib, args, tq: int, tk: int) -> tuple:
    """ms per call of K5 (with its split) and of K6."""
    q, k = args[0], args[1]
    pointers = [a.data_ptr() for a in args]
    dh = C // HEADS
    n_split, per = fl.dq_key_split(q.dtype, dh, B, HEADS, tq, tk)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(k)
    scratch = torch.empty(n_split, B, tq, C, device="cuda") if n_split > 1 else None
    stream = torch.cuda.current_stream().cuda_stream
    shape = [B, tq, tk, C, HEADS, 0, 1]
    k5, k6 = lib.savqa_flash_graph_attention_bwd_dq, lib.savqa_flash_graph_attention_bwd_dkv
    for fn, n_ptr, n_int in ((k5, 12, 11), (k6, 12, 7)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float,
                                                                            ctypes.c_void_p]

    def call_k5():
        _build.check(k5(*pointers, dq.data_ptr(), None if scratch is None else scratch.data_ptr(),
                        *shape, fl.DQ_PATHS.index("tensor-core"), fl.TC_Q_TILE, n_split, per,
                        1.0 / dh ** 0.5, stream), "K5")

    def call_k6():
        _build.check(k6(*pointers, dk.data_ptr(), dv.data_ptr(), *shape, 1.0 / dh ** 0.5,
                        stream), "K6")

    return timed(call_k5), timed(call_k6), n_split


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the knock-outs are timed on the card only", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, tq, tk in SHAPES:
        args = inputs(gen, tq, tk)
        for name, lib in libs.items():
            k5_ms, k6_ms, n_split = time_entries(lib, args, tq, tk)
            print(f"bf16 {label}, {name}: K5 ({n_split} key shard(s)) {k5_ms:.4f} ms, "
                  f"K6 {k6_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
