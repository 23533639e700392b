"""Where K4's tensor-core kernel spends its time, by knock-out.

No profiler shows one kernel's stalls on a card where ``ncu`` does not run,
so this script times copies of ``csrc/flash_graph_attention.cu`` with one
part of the bf16 kernel removed: the difference to the unchanged source is
what that part costs while everything else goes on. The copies compute
garbage; only their times mean anything. Each copy is built by nvcc into
``build/knockouts/`` (all at once) and its C entry point is called through
ctypes on the same inputs, so the times are of the kernels alone, without
the Python wrapper's allocations and checks.

    python3 scripts/k4_knockouts.py            # needs an H100 and nvcc

Prints the card and, per shape and variant, ms per launch (mean of 50 after
5 warm-ups, CUDA events), the unchanged source first and last.
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

# variant -> (text in the source, what replaces it); every text must occur
NEXT_STEP = "if (step + kTcStages - 1 < step_hi) load_step(step + kTcStages - 1);"
KV_COPIES = """    stage_head_tile<DH, kThr>(Ks, kb, j0, Tk, kBK, C, c0, dh);
    stage_head_tile<DH, kThr>(Ks + kBK * kLd, vb, j0, Tk, kBK, C, c0, dh);
"""
GRAPH_COPIES = "if (graph_quads) {"
EXP = "const float e = fast_exp2(s[nb][c] - (c < 2 ? mn_a : mn_b));"
VARIANTS = {
    "base": [],
    # no copies after the first step's: products and softmax alone
    "no_loads": [(NEXT_STEP, "")],
    # the K and V tiles are not copied (the graph tile and the key mask are)
    "no_kv_copies": [(KV_COPIES, "")],
    # the graph tile is not copied (K, V and the key mask are)
    "no_graph_copies": [(GRAPH_COPIES, "if (true) {} else if (graph_quads) {")],
    # the exponential becomes a subtraction
    "no_exp": [(EXP, "const float e = s[nb][c] - (c < 2 ? mn_a : mn_b);")],
    # three blocks an SM become two (the registers the compiler may use go from 168 to 255)
    "two_blocks_an_sm": [("DH <= 64 ? 384 / (WARPS * 32) : 1", "DH <= 64 ? 256 / (WARPS * 32) : 1")],
    # 96 and 128 query rows a block (6 and 8 warps), two blocks an SM: less K and V traffic
    "q_tile_96": [("constexpr int kTcWarps = 4;", "constexpr int kTcWarps = 6;")],
    "q_tile_128": [("constexpr int kTcWarps = 4;", "constexpr int kTcWarps = 8;"),
                   ("DH <= 64 ? 384 / (WARPS * 32) : 1", "DH <= 64 ? 512 / (WARPS * 32) : 1")],
    # a ring of three stages: two blocks an SM fit (registers capped at 168, then at 255)
    "three_stages": [("constexpr int kTcStages = 2;", "constexpr int kTcStages = 3;")],
    "three_stages_255_registers": [
        ("constexpr int kTcStages = 2;", "constexpr int kTcStages = 3;"),
        ("DH <= 64 ? 384 / (WARPS * 32) : 1", "DH <= 64 ? 256 / (WARPS * 32) : 1")],
    "base_again": [],
}


def build() -> dict:
    out_dir = _build.BUILD_DIR / "knockouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC_DIR / "flash_graph_attention.cu").read_text()
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
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def inputs(gen, tq: int, tk: int):
    q, k, v = (torch.randn(B, t, C, generator=gen, device="cuda").relu().bfloat16()
               for t in (tq, tk, tk))
    key_mask = torch.ones(B, tk, device="cuda")
    key_mask[1, tk - 100:] = 0.0
    query_mask = torch.ones(B, tq, device="cuda")
    graph = (torch.rand(B, tq, tk, generator=gen, device="cuda") > 0.5).float()
    return q, k, v, key_mask, query_mask, graph


def time_entry(lib, args, tq: int, tk: int) -> float:
    q, k, v, key_mask, query_mask, graph = args
    fn = lib.savqa_flash_graph_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    dh = C // HEADS
    n_split, per = fl.key_split(B, HEADS, tq, tk)
    out = torch.empty_like(q)
    scratch_a = torch.empty(n_split, B, HEADS, tq, dh, device="cuda")
    scratch_stats = torch.empty(3, n_split, B, HEADS, tq, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                    query_mask.data_ptr(), graph.data_ptr(), out.data_ptr(), None, None, None,
                    scratch_a.data_ptr(), scratch_stats.data_ptr(), B, tq, tk, C, HEADS, 0, 0, 1,
                    n_split, per, 1.0 / dh ** 0.5, stream)
        _build.check(status, "flash_graph_attention kernel")

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
        n_split, per = fl.key_split(B, HEADS, tq, tk)
        for name, lib in libs.items():
            print(f"K4 bf16 {label}, {n_split} key shard(s), {name}: "
                  f"{time_entry(lib, args, tq, tk):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
