"""K3's products path (float32, and bf16 at C 2,048) by variant and split.

The products path of ``csrc/ffn.cu`` runs two kernels shaped like GEMMs and
the shard-sum kernel. This script times copies of the source with one
design choice changed (the k depth of a stage, the depth of the cp.async
ring) and the unchanged source with other tile rows (f32: 64 or 128) and
the hidden width forced into other numbers of shards, so that the choices
in the source and the constants of ``ops/fused_ffn.py:products_plan`` rest
on times of this card. Each copy
is built by nvcc into ``build/k3_variants/`` (all at once) and its C entry
point is called through ctypes on the same inputs: the times are of the
kernels alone, without the Python wrapper. Every variant's output is held
against ``ffn_ln_plain`` (f32 1e-4, bf16 2^-4).

    python3 scripts/k3_variants.py            # needs an H100 and nvcc (~2 min)

Prints the card, each copy's ptxas registers and spills for the products
kernels, and per shape and variant ms per call (mean of 20 after 3
warm-ups, CUDA events), the unchanged source first and last, and each
kernel's share of the unchanged source's call (torch.profiler). The model
axis's f32 partial (16,384 rows, a hidden shard of 1,024) goes through its
own entry point the same way.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import _build  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3  # noqa: E402

# variant -> [(text in the source, what replaces it)]; every text must occur once
K_DEPTH = "__host__ __device__ constexpr int simt_k(int bm) { return bm == 64 ? 16 : 32; }"
VARIANTS = {
    "base": [],
    # f32: 16 k a stage at both tile heights, or 32 at both
    "f32_16k_stages": [(K_DEPTH, K_DEPTH.replace("bm == 64 ? 16 : 32", "16"))],
    "f32_32k_stages": [(K_DEPTH, K_DEPTH.replace("bm == 64 ? 16 : 32", "32"))],
    # f32: a ring of three stages, not two; bf16: two, not three
    "f32_three_stages": [("constexpr int kSimtStages = 2;", "constexpr int kSimtStages = 3;")],
    "bf16_two_stages": [("constexpr int kMmaStages = 3;", "constexpr int kMmaStages = 2;")],
    # bf16: 32 k a stage, not 64
    "bf16_32k_stages": [("constexpr int kHK = 64;", "constexpr int kHK = 32;")],
    "base_again": [],
}
# (rows, C, dtype): the variants' f32 rows, the training checks' 16,384, the
# wide FFN of x2_fusion_dec_mil2 in both dtypes
SHAPES = ((64, 512, torch.float32), (3136, 512, torch.float32), (6336, 512, torch.float32),
          (16384, 512, torch.float32), (19200, 512, torch.float32),
          (3136, 2048, torch.float32), (3136, 2048, torch.bfloat16))
SPLITS = (1, 2, 3, 4, 8)   # forced shard counts, on the unchanged source
TILE_ROWS = {torch.float32: (64, 128), torch.bfloat16: (128,)}
PARTIAL = (16384, 512, 1024)   # the model axis's f32 partial: rows, C, hidden shard


def build() -> dict:
    out_dir = _build.BUILD_DIR / "k3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text0 = (_build.CSRC_DIR / "ffn.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = text0
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
        for line in _build.register_lines(log):
            if "product" in line:
                print(f"  {name}: {line}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def k3_call(lib, args, tile_rows: int, n_split: int):
    """A call of savqa_ffn_ln on ``args`` (or, with three weights,
    savqa_ffn_partial) in tiles of ``tile_rows`` with the hidden width in
    ``n_split`` shards; returns (call, out)."""
    x, w1 = args[0], args[1]
    rows, c = x.shape
    hidden = w1.shape[0]
    chunks = hidden // k3.HIDDEN_CHUNK
    per = -(-chunks // n_split)
    n_split = -(-chunks // per)
    h = torch.empty(rows, hidden, dtype=x.dtype, device=x.device)
    partial = torch.empty(n_split, rows, c, device=x.device)
    if len(args) == 4:   # the partial entry: x, w1, b1, w2
        out = torch.empty(rows, c, device=x.device)
        keep = (*args, h, partial, out)
        fn = lib.savqa_ffn_partial
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    else:
        out = torch.empty_like(x)
        keep = (*args, out, h, partial)
        fn = lib.savqa_ffn_ln
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in keep]
    call_args = ptrs + [rows, c, hidden, k3._DTYPES[x.dtype], n_split, per, tile_rows,
                        torch.cuda.current_stream().cuda_stream]

    def call(keep=keep):   # the inputs live as long as the call
        _build.check(fn(*call_args), "K3")
    return call, out


def kernel_shares(call) -> str:
    """ms a call of each kernel over 5 calls (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.split("::")[-1].split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return ", ".join(f"{name} {us / 5e3:.4f} ms" for name, us in by_name.items()) or "not measured"


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the variants are timed on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(f"K3 {str(dtype)[6:]} rows={rows} C={c}", cs.k3_inputs(gen, rows, c, dtype),
              k3.products_plan(rows, c, 4 * c, dtype)) for rows, c, dtype in SHAPES]
    rows, c, hidden = PARTIAL
    cases.append((f"K3 partial float32 rows={rows} C={c} hidden={hidden}",
                  cs.k3_inputs(gen, rows, c, torch.float32, hidden)[:4],
                  k3.products_plan(rows, c, hidden, torch.float32)))
    for label, args, (tile_rows, n_split, _) in cases:
        dtype = args[0].dtype
        plain = k3.ffn_partial_plain if len(args) == 4 else k3.ffn_ln_plain
        want = plain(*args).float()
        runs = [(name, lib, tile_rows, n_split) for name, lib in libs.items()]
        runs += [(f"base, tiles of {t}, {n} shard(s)", libs["base"], t, n)
                 for t in TILE_ROWS[dtype] for n in SPLITS if (t, n) != (tile_rows, n_split)]
        for name, lib, t, n in runs:
            call, out = k3_call(lib, args, t, n)
            call()
            err = (out.float() - want).abs().max().item()
            cs.check(err <= cs.TOL[dtype], f"{label} {name}: max|kernel-plain| {err:.3g}")
            print(f"{label} (the rule: tiles of {tile_rows}, {n_split} shard(s)) {name}: "
                  f"{cs.time_ms(call):.4f} ms", flush=True)
        call, _ = k3_call(libs["base"], args, tile_rows, n_split)
        print(f"{label} base by kernel: {kernel_shares(call)}", flush=True)
    print(f"card: {card}")
    return 1 if cs.failures else 0


if __name__ == "__main__":
    sys.exit(main())
