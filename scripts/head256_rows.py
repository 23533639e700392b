"""Query rows a block of K1's tensor-core kernel at head width 256 and of
K4's chunked tensor-core kernel above it.

Instance 256 of K1's ``graph_attention_ln_tc_kernel`` takes 64 query rows
a block (4 warps) or 128 (8 warps), and so does instance 256 of K4's
``flash_graph_attention_tc_kernel`` (at 64 the graph tile staged, at 128
read in fragments from device memory): the C entry points' ``q_tile``
chooses. K4's chunked form ``flash_graph_attention_tc_chunk_kernel`` runs
128 rows; its 64-row form is a copy of ``csrc/`` with the launch changed,
built by nvcc into ``build/head256_rows/``. Each is one block an SM by
shared memory. This script calls the C entry points through ctypes on the
same inputs (bf16), holds the two outputs to each other and to the plain
version, and times them in turns (64, 128, 128, 64): the rows a block that
``fused_graph_attention.tc_warps`` and ``flash_graph_attention.tc_rows``
pick rest on these times.

    python3 scripts/head256_rows.py     # needs an H100 and nvcc (~2 min with the build)

Prints the card and, per shape and rows a block, ms per launch (the
smaller of two turns, each the mean of 20 after 3 warm-ups, CUDA events).
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
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1  # noqa: E402

HEADS = 8
OUT = ROOT / "build" / "head256_rows"
CHUNK_LAUNCH = "return launch_tc<0, kChunkWarps>(p);"
# K1: (label, B, Tq, Tk) at C 2,048 with 8 heads of 256
K1_SHAPES = (("C=2048 H=8 L=128 B=8", 8, 128, 128), ("C=2048 H=8 L=512 B=8", 8, 512, 512),
             ("C=2048 H=8 L=450 B=4", 4, 450, 450), ("C=2048 H=8 L=100 B=8", 8, 100, 100))
# K4: (label, C, B, Tq, Tk) at 8 heads of 256 (instance 256), 320 and 512
# (the chunked kernel)
K4_SHAPES = (("C=2048 H=8 L=1536 B=2", 2048, 2, 1536, 1536),
             ("C=2048 H=8 L=1536 B=4", 2048, 4, 1536, 1536),
             ("C=2048 H=8 Tq=100 Tk=1536 B=4", 2048, 4, 100, 1536),
             ("C=2560 H=8 L=1536 B=2", 2560, 2, 1536, 1536),
             ("C=4096 H=8 L=1536 B=2", 4096, 2, 1536, 1536),
             ("C=4096 H=8 Tq=100 Tk=1536 B=4", 4096, 4, 100, 1536))


def k1_call(args, q_tile: int) -> torch.Tensor:
    """One launch of K1's tensor-core path with ``q_tile`` rows a block."""
    q, k, v, key_mask, query_mask, graph, res, gamma, beta = args
    b, tq, c = q.shape
    fn = _build.library("graph_attention").savqa_graph_attention_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    o = torch.empty(*q.shape, dtype=torch.float32, device=q.device)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                query_mask.data_ptr(), graph.data_ptr(), res.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), out.data_ptr(), o.data_ptr(), b, tq, k.shape[1], c, HEADS, 0, 1,
                k1.K1_PATHS.index("tensor-core"), q_tile, 1.0 / (c // HEADS) ** 0.5,
                torch.cuda.current_stream().cuda_stream)
    _build.check(status, "graph_attention_ln kernel")
    return out


def chunk64_library() -> ctypes.CDLL:
    """K4's library with the chunked kernel at 64 rows a block (4 warps)."""
    d = OUT / "chunk64"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC_DIR, d)
    src = (d / "flash_graph_attention.cu").read_text()
    if CHUNK_LAUNCH not in src:
        raise SystemExit(f"{CHUNK_LAUNCH!r} not in flash_graph_attention.cu")
    (d / "flash_graph_attention.cu").write_text(
        src.replace(CHUNK_LAUNCH, "return launch_tc<0, 4>(p);"))
    lib = d / "lib.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
                    str(d / "flash_graph_attention.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def k4_call(args, q_tile: int, lib=None) -> torch.Tensor:
    """One launch of K4's tensor-core kernel or its chunked form (emit
    "out", l1) with ``q_tile`` rows a block (the chunked form: 128 to the
    entry, the rows of ``lib``'s launch) and the key split ``key_split``
    gives them."""
    q, k, v, key_mask, query_mask, graph = args
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // HEADS
    n_split, per = fl.key_split(b, HEADS * fl.wide_chunks(dh), tq, tk, q_tile)
    if dh > 256:
        q_tile = fl.CHUNK_ROWS
    lib = lib or _build.library("flash_graph_attention")
    fn = lib.savqa_flash_graph_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    scratch = [None, None]
    if n_split > 1:
        scratch = [torch.empty(n_split, b, HEADS, tq, dh, device=q.device),
                   torch.empty(3, n_split, b, HEADS, tq, device=q.device)]
    out = torch.empty_like(q)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
                query_mask.data_ptr(), graph.data_ptr(), out.data_ptr(), None, None, None,
                *(None if t is None else t.data_ptr() for t in scratch), b, tq, tk, c, HEADS, 0, 0,
                1, n_split, per, q_tile, 1.0 / dh ** 0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "flash_graph_attention kernel")
    return out


def compare(what: str, call, plain, args, picked: int) -> bool:
    got = {rows: call(args, rows) for rows in (64, 128)}
    want = plain()
    torch.cuda.synchronize()
    diff = (got[64].float() - got[128].float()).abs().max().item()
    err = max((g.float() - want.float()).abs().max().item() for g in got.values())
    times = {64: [], 128: []}
    for rows in (64, 128, 128, 64):
        times[rows].append(cs.time_ms(lambda: call(args, rows)))
    print(f"{what} bf16: 64 rows a block {min(times[64]):.4f} ms, 128 rows "
          f"{min(times[128]):.4f} ms (two turns each: {times[64]} / {times[128]}); "
          f"max|64 rows - 128 rows| {diff:.3g}, max|kernel - plain| {err:.3g} "
          f"(the wrapper's rows: {picked})", flush=True)
    return err <= cs.TOL[torch.bfloat16]


def main() -> int:
    if not torch.cuda.is_available():
        print("head256_rows: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(256)
    ok = True
    for label, b, tq, tk in K1_SHAPES:
        args = cs.k1_inputs(gen, tq, tk, torch.bfloat16, b, c=2048)
        ok &= compare(f"K1 {label}", k1_call, lambda: k1.graph_attention_ln_plain(
            *args, HEADS, "l1"), args, 16 * k1.tc_warps(tq, 256))
    chunk64 = chunk64_library()
    for label, c, b, tq, tk in K4_SHAPES:
        args = cs.flash_inputs(gen, label, tq, tk, torch.bfloat16, c, b)
        call = k4_call
        if c // HEADS > 256:   # 64 rows: the copy's launch
            call = lambda a, rows: k4_call(a, rows, chunk64 if rows == 64 else None)
        ok &= compare(f"K4 {label}", call, lambda: fl.flash_graph_attention_plain(
            *args, HEADS, "l1"), args, fl.tc_rows(torch.bfloat16, c // HEADS, tq))
        del args
        torch.cuda.empty_cache()
    if not ok:
        print("head256_rows: a row tile disagrees with the plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
