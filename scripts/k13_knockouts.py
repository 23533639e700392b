"""Where K1's and K3's bf16 tensor-core kernels spend their time, by knock-out.

The counterpart of ``scripts/k56_knockouts.py`` for K1 (graph attention +
LayerNorm, ``csrc/graph_attention.cu``) and K3 (FFN + LayerNorm,
``csrc/ffn.cu``): it times copies of each source with one part of the bf16
kernels removed or changed; the difference to the unchanged source is what
that part costs while everything else goes on. Knock-out copies compute
garbage; only their times mean anything. Each copy is built by nvcc into
``build/knockouts_k13/`` (all at once) and its C entry point is called
through ctypes on the same inputs, so the times are of the kernels alone
(K1's epilogue and K3's shard sum included), without the Python wrappers'
allocations and checks. K1's SIMT kernel, which bf16 took before, is timed
on the same inputs through the unchanged source.

    python3 scripts/k13_knockouts.py            # needs an H100 and nvcc

Prints the card and, per shape and variant, ms per call (mean of 50 after 5
warm-ups, CUDA events), the unchanged source first and last; the ptxas log
of every copy is saved beside it.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from structured_alignment_vqa_tpu_torch.ops import _build  # noqa: E402
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3  # noqa: E402

C, HEADS, HIDDEN = 512, 8, 2048
# (label, batch, Tq, Tk): the shapes of chip_smoke.py's K1 phase
K1_SHAPES = (("self L=66", 128, 66, 66), ("self L=128", 128, 128, 128),
             ("cross Tq=1 Lk=66", 128, 1, 66), ("cross Tq=1 Lk=128", 128, 1, 128),
             ("self L=66 B=4", 4, 66, 66), ("cross Tq=1 Lk=66 B=4", 4, 1, 66))
K3_ROWS = (16384, 8448, 6144, 128, 264, 4)

GRAPH_LOAD = ("    load_graph_frag<kNS>(gr, graph_a, graph_b, step * kStep + 2 * t, Tk, real_a, "
              "real_b,\n                         graph_pairs);\n")
# variant -> (source, [(text in the source, what replaces it)]); every text must occur once
VARIANTS = {
    "k1_base": ("graph_attention", []),
    # the residual + LayerNorm kernel is not launched
    "k1_no_epilogue": ("graph_attention", [
        ("  graph_attention_ln_epilogue_kernel<<<",
         "  if (false) graph_attention_ln_epilogue_kernel<<<")]),
    # the graph is not read: every entry is 1
    "k1_no_graph_reads": ("graph_attention", [
        (GRAPH_LOAD, "#pragma unroll\n    for (int nb = 0; nb < kNS; ++nb)\n"
                     "      gr[nb][0] = gr[nb][1] = gr[nb][2] = gr[nb][3] = 1.f;\n")]),
    # 32 query rows a block (2 warps), not 64
    "k1_two_warps": ("graph_attention", [
        ("launch_tc_dh<DH, 1> : launch_tc_dh<DH, 4>",
         "launch_tc_dh<DH, 1> : launch_tc_dh<DH, 2>")]),
    # registers not capped (two blocks of 4 warps an SM at head width 64), or
    # capped for four (128 a thread)
    "k1_two_blocks": ("graph_attention", [
        ("__launch_bounds__(NW * 32, DH <= 64 ? 3 : 1)", "__launch_bounds__(NW * 32)")]),
    "k1_four_blocks": ("graph_attention", [
        ("__launch_bounds__(NW * 32, DH <= 64 ? 3 : 1)", "__launch_bounds__(NW * 32, 4)")]),
    "k3_base": ("ffn", []),
    # no weight copies after the first chunk's
    "k3_no_weight_loads": ("ffn", [
        ("    load_w2(j);\n", "    if (j == j_begin) load_w2(j);\n"),
        ("    if (j + 1 < j_end) load_w1(j + 1);\n", "")]),
    # the first product's mma.sync removed (its ldmatrix kept)
    "k3_no_first_mma": ("ffn", [
        ("          mma_bf16(hacc[2 * p], a, bq[p][0], bq[p][1]);\n"
         "          mma_bf16(hacc[2 * p + 1], a, bq[p][2], bq[p][3]);\n", "")]),
    # the second product's mma.sync removed (its ldmatrix kept)
    "k3_no_second_mma": ("ffn", [
        ("          mma_bf16(y[rb][2 * p], a[rb], bq[0], bq[1]);\n"
         "          mma_bf16(y[rb][2 * p + 1], a[rb], bq[2], bq[3]);\n", "")]),
    "k1_base_again": ("graph_attention", []),
    "k3_base_again": ("ffn", []),
}


def build() -> dict:
    out_dir = _build.BUILD_DIR / "knockouts_k13"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (source, edits) in VARIANTS.items():
        text = (_build.CSRC_DIR / f"{source}.cu").read_text()
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


def k1_call(lib, gen, b: int, tq: int, tk: int, tensor_cores: bool):
    """A call of K1's entry point on bf16 inputs at (b, tq, tk): ragged key
    masks, a 0/1 graph at density 0.3, renorm l1."""
    dev = "cuda"
    n_keys = torch.randint(1, tk + 1, (b,), generator=gen, device=dev)
    key_mask = (torch.arange(tk, device=dev)[None] < n_keys[:, None]).float()
    query_mask = key_mask[:, :tq].contiguous() if tq == tk else torch.ones(b, tq, device=dev)
    graph = (torch.rand(b, tq, tk, generator=gen, device=dev) < 0.3).float()
    q, k, v = (torch.randn(b, t, C, generator=gen, device=dev).relu().bfloat16()
               for t in (tq, tk, tk))
    res = torch.randn(b, tq, C, generator=gen, device=dev).bfloat16()
    gamma, beta = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    out = torch.empty_like(q)
    o = torch.empty(b, tq, C, device=dev)
    keep = (q, k, v, key_mask, query_mask, graph, res, gamma, beta, out, o)
    fn = lib.savqa_graph_attention_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    args = [t.data_ptr() for t in keep] + [b, tq, tk, C, HEADS, 0, 1, int(tensor_cores),
                                           (C // HEADS) ** -0.5,
                                           torch.cuda.current_stream().cuda_stream]

    def call(keep=keep):   # the inputs live as long as the call
        _build.check(fn(*args), "K1")
    return call


def k3_call(lib, gen, n: int):
    """A call of K3's entry point on bf16 inputs of n rows, split as the
    wrapper splits them."""
    dev = "cuda"
    x = torch.randn(n, C, generator=gen, device=dev).bfloat16()
    w1 = (torch.randn(HIDDEN, C, generator=gen, device=dev) / C ** 0.5).bfloat16()
    b1 = (0.05 * torch.randn(HIDDEN, generator=gen, device=dev)).bfloat16()
    w2 = (torch.randn(C, HIDDEN, generator=gen, device=dev) / HIDDEN ** 0.5).bfloat16()
    b2 = torch.zeros(C, device=dev).bfloat16()
    gamma, beta = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    n_split, per = k3.ffn_split(n, C, HIDDEN)
    out = torch.empty_like(x)
    partial = torch.empty(n_split, n, C, device=dev)
    keep = (x, w1, b1, w2, b2, gamma, beta, out, partial)
    fn = lib.savqa_ffn_ln
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    # the row-tile kernel takes no hidden scratch and reads no tile rows
    ptrs = [t.data_ptr() for t in keep]
    args = ptrs[:8] + [None] + ptrs[8:] + [n, C, HIDDEN, 1, n_split, per, k3.PRODUCT_TILE,
                                           torch.cuda.current_stream().cuda_stream]

    def call(keep=keep):   # the inputs live as long as the call
        _build.check(fn(*args), "K3")
    return call, n_split


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the knock-outs are timed on the card only", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build()
    for name in ("k1_base", "k3_base"):
        log = (_build.BUILD_DIR / "knockouts_k13" / f"lib{name}.log").read_text()
        for line in _build.register_lines(log):
            if "_tc_" in line or "shard_sum" in line:
                print(f"  {name}: {line}")
    for label, b, tq, tk in K1_SHAPES:
        for name, lib in libs.items():
            if not name.startswith("k1_"):
                continue
            gen = torch.Generator(device="cuda").manual_seed(0)
            call = k1_call(lib, gen, b, tq, tk, True)
            print(f"K1 bf16 {label}, {name}: {timed(call):.4f} ms", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        call = k1_call(libs["k1_base"], gen, b, tq, tk, False)
        print(f"K1 bf16 {label}, SIMT kernel: {timed(call):.4f} ms", flush=True)
    for n in K3_ROWS:
        for name, lib in libs.items():
            if not name.startswith("k3_"):
                continue
            gen = torch.Generator(device="cuda").manual_seed(0)
            call, n_split = k3_call(lib, gen, n)
            print(f"K3 bf16 rows={n} ({n_split} shard(s)), {name}: {timed(call):.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
