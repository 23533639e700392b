"""K6's float32 kernel by design variant, timed and compared bit for bit.

No profiler shows one kernel's stalls on a card where ``ncu`` does not run,
so this script times copies of ``csrc/`` with one part of K6's f32 kernel
changed: the difference to the unchanged source is what that part costs or
saves. Each copy's ``flash_graph_attention_bwd.cu`` is built by nvcc into
``build/k6_f32_variants/`` (all at once) and its C entry
``savqa_flash_graph_attention_bwd_dkv`` is
called through ctypes on the same inputs, so the times are of the kernel
alone, without the Python wrapper.

    python3 scripts/k6_f32_variants.py         # needs an H100 and nvcc (~2 min)

Variants: ``reciprocal``, the source as it is (n = e g / D and p = e / z
through the rows' reciprocals, ``div_rn``); ``division``, the same kernel
with the two IEEE divisions per (key, row) entry of the first f32 kernel
(``ds_entry``); ``multiply``, e g (1 / D) and e (1 / z) rounded once each,
which are not the divisions' bits. Prints the card and, per shape, renorm
and variant, ms per launch (mean of 20 after 3 warm-ups, CUDA events) and
whether dK and dV equal the ``division`` variant's bit for bit (else the
largest difference over the largest magnitude).
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

SOURCE = "flash_graph_attention_bwd.cu"
OUT = ROOT / "build" / "k6_f32_variants"
# (label, Tq, Tk, heads) at B 4, 64 channels a head
SHAPES = (("self L=1536", 1536, 1536, 8), ("self L=1506+30", 1536, 1536, 8),
          ("odd Tq=200 Tk=700", 200, 700, 8), ("ring shard Tq=768 Tk=768", 768, 768, 8),
          ("cross Tq=1 Lk=1536", 1, 1536, 8), ("self L=1536 4 heads", 1536, 1536, 4))
RCP_CALL = ("ds_entry_rcp(w[i][c], dn[i][c], Gs[f32::swz<kF32Keys>(r, kw[i])], masked[i], t, rz, rd,\n"
            "                     scale, &n, &ds);")
DIV_RN = "  float q = a * rb;\n  float r = fmaf(-b, q, a);"
# variant -> [(file, text, replacement)]; every text must occur in its file
VARIANTS = {
    "reciprocal": [],
    "division": [(SOURCE, RCP_CALL, "ds_entry(w[i][c], dn[i][c], Gs[f32::swz<kF32Keys>(r, kw[i])], "
                                    "masked[i], t, scale, &n, &ds);")],
    "multiply": [("simt_f32.cuh", DIV_RN,
                  "  return a * rb;\n  float q = a * rb;\n  float r = fmaf(-b, q, a);")],
}


def build() -> dict:
    """{variant: the C entry of its library}, every copy built at once."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        for file, old, new in edits:
            text = (d / file).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {file} no longer holds {old!r}")
            (d / file).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log[-4000:]}")
        print(name, [line for line in _build.register_lines(log) if "dkv_f32" in line], flush=True)
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).savqa_flash_graph_attention_bwd_dkv
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_f32_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build()
    print(f"card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for label, tq, tk, heads in SHAPES:
        q, k, v, key_mask, query_mask, graph = cs.flash_inputs(gen, label.split(" 4")[0], tq, tk,
                                                               torch.float32)
        c = 64 * heads
        q, k, v = (t[..., :c].contiguous() for t in (q, k, v))
        b = q.shape[0]
        dy = torch.randn(b, tq, c, generator=gen, device="cuda")
        for renorm in fl.RENORMS:
            out, m, z, bsum = fl.flash_graph_attention(q, k, v, key_mask, query_mask, graph,
                                                       heads, renorm, "stats")
            d_out, delta = fl.masked_grad_and_delta(out, dy, query_mask, heads)
            got, times = {}, {}
            for name, fn in fns.items():
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                ptrs = [t.data_ptr() for t in (q, k, v, key_mask, graph, m, z, bsum, delta,
                                               d_out, dk, dv)]
                args = ptrs + [b, tq, tk, c, heads, fl.RENORMS.index(renorm), 0,
                               (c // heads) ** -0.5, torch.cuda.current_stream().cuda_stream]
                if fn(*args):
                    raise SystemExit(f"{name}: the launch failed")
                torch.cuda.synchronize()
                got[name] = (dk.clone(), dv.clone())
                times[name] = cs.time_ms(lambda: fn(*args))
            ref = got["division"]

            def bits(name):
                if all(torch.equal(x, y) for x, y in zip(got[name], ref)):
                    return "equal"
                return f"{max(cs.rel_err(x, y) for x, y in zip(got[name], ref)):.3g}"

            print(f"{label} {renorm}: " + ", ".join(
                f"{name} {times[name]:.4f} ms (bits {bits(name)})" for name in fns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
