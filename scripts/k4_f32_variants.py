"""K4's float32 kernel by design variant, and K2's float32 kernels one by one.

No profiler shows one kernel's stalls on a card where ``ncu`` does not run,
so this script times copies of ``csrc/flash_graph_attention.cu`` and
``csrc/simt_f32.cuh`` with one part changed: the difference to the
unchanged source is what that part costs or saves. Each copy is built by
nvcc into ``build/k4_f32_variants/`` (all at once) and its C entry point is
called through ctypes on the same inputs, so the times are of the kernels
alone, without the Python wrapper. Knock-outs (no exp) compute garbage;
only their times mean anything. Then K2's f32 call at B 128, L 128 under
torch.profiler: the device time of each of its four kernels.

    python3 scripts/k4_f32_variants.py         # needs an H100 and nvcc (~2 min)

Prints the card and, per shape and variant, ms per launch (mean of 30
after 5 warm-ups, CUDA events), the unchanged source first and last.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import _build  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as fl  # noqa: E402

OUT = ROOT / "build" / "k4_f32_variants"
# (label, B, Tq, Tk, C, heads)
SHAPES = (("self L=1536", 4, 1536, 1536, 512, 8), ("self L=1536 4 heads", 4, 1536, 1536, 256, 4),
          ("cross Tq=1 Lk=1536", 4, 1, 1536, 512, 8))
D_LOOP = "#pragma unroll 2\n  for (int d = 0; d < dh; d += 4) {"
N_LOOP = "#pragma unroll 8\n  for (int n = 0; n < N; ++n) {"
EXP = "const float p = expf(s[i][c] - m_new);"
LAUNCH = "launch_f32_dh<4, 4>(p)"
# variant -> [(file, text, replacement)]; every text must occur
VARIANTS = {
    "base": [],
    # the first product's d loop unrolled by 4
    "unroll_d4": [("simt_f32.cuh", D_LOOP, "#pragma unroll 4\n  for (int d = 0; d < dh; d += 4) {")],
    # the second product's loop unrolled by 4 (the first f32 source's choice)
    "unroll_n4": [("simt_f32.cuh", N_LOOP, "#pragma unroll 4\n  for (int n = 0; n < N; ++n) {")],
    # the exponential of the weights becomes a subtraction (its cost)
    "no_exp": [("simt_f32.cuh", EXP, "const float p = s[i][c] - m_new;")],
    # 128 query rows a block (8 warps of 16 rows), one block an SM
    "q_tile_128": [("flash_graph_attention.cu", LAUNCH, "launch_f32_dh<8, 4>(p)")],
    # 32 rows a warp (8 x 8 tiles a lane: 16 FMAs a shared load in both
    # products): 2 warps a block (64 rows, two blocks an SM) or 4 (128 rows, one)
    "rows32_w2": [("flash_graph_attention.cu", LAUNCH, "launch_f32_dh<2, 8>(p)")],
    "rows32_w4": [("flash_graph_attention.cu", LAUNCH, "launch_f32_dh<4, 8>(p)")],
}


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC_DIR, d)
        for fname, text, new in edits:
            src = (d / fname).read_text()
            if text not in src:
                raise SystemExit(f"{name}: {text!r} not in {fname}")
            (d / fname).write_text(src.replace(text, new))
        lib = d / "lib.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
             str(d / "flash_graph_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        for line in _build.register_lines(log):
            if "f32_kernel<64, " in line:
                print(f"  {name}: {line}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def time_entry(lib, a, heads: int, tq: int, tk: int) -> float:
    fn = lib.savqa_flash_graph_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    q, k, v, key_mask, query_mask, graph = a
    b, _, c = q.shape
    q_tile, n_split, per = fl.f32_plan(b, heads, tq, tk)
    out = torch.empty_like(q)
    scratch = [None, None]
    if n_split > 1:
        scratch = [torch.empty(n_split * b * heads * tq * (c // heads), device="cuda"),
                   torch.empty(3 * n_split * b * heads * tq, device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                    query_mask.data_ptr(), graph.data_ptr(), out.data_ptr(), None, None, None,
                    *(None if s is None else s.data_ptr() for s in scratch), b, tq, tk, c, heads,
                    0, 0, 0, n_split, per, q_tile, (c // heads) ** -0.5, stream)
        if status != 0:
            raise SystemExit(f"launch failed: {status}")

    return cs.time_ms(call, iters=30, warmup=5)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_f32_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(4)
    order = list(VARIANTS) + ["base"]
    for label, b, tq, tk, c, heads in SHAPES:
        q, k, v, key_mask, query_mask, graph = cs.flash_inputs(gen, label, tq, tk, torch.float32)
        a = tuple(t[..., :c].contiguous() for t in (q, k, v)) + (key_mask, query_mask, graph)
        for name in order:
            print(f"K4 f32 {label} {name}: {time_entry(libs[name], a, heads, tq, tk):.4f} ms",
                  flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

    _build.build_all()
    a, dy = cs.k2_inputs(gen, 128, 128, torch.float32, 128)
    for _ in range(3):
        k1.fused_graph_attention_ln_bwd(*a, dy, cs.HEADS, "l1")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k1.fused_graph_attention_ln_bwd(*a, dy, cs.HEADS, "l1")
        torch.cuda.synchronize()
    per: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 10
    for name, us in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"K2 f32 B=128 L=128, a call: {us / 1e3:.4f} ms {name[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
