"""K4's float32 kernels above head width 128 by design variant.

Copies of ``csrc/`` with one part changed, each built by nvcc into
``build/k4_f32_head256_variants/`` (all at once) and called through its C
entry point on the same inputs (B 2, L 1,536, 8 heads of 256, 320 and 512,
float32), so the times are of the kernels alone. Each variant's output is
held to the plain version (1e-4): a variant that holds may become the
design. The variants:

- ``base``: the source (head width 256: instance 256 of the f32 kernel, Q
  resident, 64 rows a block, 32-key steps; above: the chunked f32 kernel,
  128 rows a block).
- ``chunked_64rows``: the chunked kernel at 64 rows a block (4 warps).
- ``dh256_chunked``: head width 256 through the chunked kernel too (128
  rows a block).
- ``pv_unroll8``: the tiles' second product unrolled by 8 at every width
  (the source: by 2 above head width 128, where eight copies' V loads
  spill).
- ``abt_unroll1``: the first product unrolled by 1 (not 2).

    python3 scripts/k4_f32_head256_variants.py   # needs an H100 and nvcc (~3 min)

Prints the card and, per shape and variant, ms per launch (mean of 20
after 3 warm-ups, CUDA events) and the largest error against plain.
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

OUT = ROOT / "build" / "k4_f32_head256_variants"
HEADS, B, L = 8, 2, 1536
CS = (2048, 2560, 4096)
SRC = "flash_graph_attention.cu"
CHUNK64 = "launch_f32<0, kChunkWarps, 4>(p)"
CHUNKED = "const bool chunked = dh > kTcMaxDh;"
PV = "#pragma unroll (DH > 128 ? 2 : 8)"
ABT = "#pragma unroll 2\n  for (int d = 0; d < dh; d += 4) {"
VARIANTS = {
    "base": [],
    "chunked_64rows": [(SRC, CHUNK64, "launch_f32<0, 4, 4>(p)")],
    "dh256_chunked": [(SRC, CHUNKED, "const bool chunked = dh > 128;")],
    "pv_unroll8": [("simt_f32.cuh", PV, "#pragma unroll 8")],
    "abt_unroll1": [("simt_f32.cuh", ABT, "#pragma unroll 1\n  for (int d = 0; d < dh; d += 4) {")],
}
# rows a block each variant's entry asks for at head width 256 (the
# chunked kernel's entry takes 128; chunked_64rows runs 4 warps under it)
ROWS = {"dh256_chunked": {False: 128}}


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
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(d / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        for line in _build.register_lines(log):
            if "f32_chunk_kernel" in line or "f32_kernel<256" in line:
                print(f"  {name}: {line}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def entry(lib, a, name: str):
    """The variant's K4 call (emit "out", l1) with the wrapper's plan (its
    rows a block as ``ROWS`` says)."""
    fn = lib.savqa_flash_graph_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    q, k, v, key_mask, query_mask, graph = a
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // HEADS
    q_tile = fl.k4_f32_plan(dh, b, HEADS, tq, tk)[0]
    q_tile = ROWS.get(name, {}).get(dh > 256, q_tile)
    n_split, per = fl.kernel_key_split(torch.float32, dh, b, HEADS, tq, tk)
    assert n_split == 1
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                    query_mask.data_ptr(), graph.data_ptr(), out.data_ptr(), None, None, None,
                    None, None, b, tq, tk, c, HEADS, 0, 0, 0, n_split, per, q_tile,
                    dh ** -0.5, stream)
        if status != 0:
            raise SystemExit(f"launch failed: {status}")
        return out

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_f32_head256_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(320)
    ok = True
    for c in CS:
        a = cs.flash_inputs(gen, "self L=1536", L, L, torch.float32, c, B)
        want = fl.flash_graph_attention_plain(*a, HEADS, "l1")
        for name in list(VARIANTS) + ["base"]:
            call = entry(libs[name], a, name)
            err = (call() - want).abs().max().item()
            ok &= err <= cs.TOL[torch.float32]
            print(f"K4 f32 C={c} H={HEADS} L={L} B={B} {name}: {cs.time_ms(call):.4f} ms, "
                  f"max|kernel - plain| {err:.3g}", flush=True)
        del a, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
