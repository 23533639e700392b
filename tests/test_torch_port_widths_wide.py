"""The widths above the old domain D (C up to 2,048, head widths up to 256,
FFN hidden width up to 8,192): the kernels now take every width the JAX
kernels take.

On the CPU no kernel launches, so this file holds what decides a launch on
the card, at sampled widths (not a sweep):

* every wrapper (K1 and K2 both entries each, K3's three entries, K4-K6)
  takes C 2,049-16,384 and head widths 257-2,048, and the plan and shared
  memory of the kernel each call takes fit a block, at the lengths each
  kernel sees;
* the plain versions at new widths against the JAX kernels in Pallas
  interpret mode, within 1e-5: K3 at C 2,056 and 4,096 (hidden width 4C),
  K1/K2 and K4-K6 at head widths 512 and 320.

``chip_smoke.py`` holds each kernel against these plain versions on the card
at the new widths (the kernel phases' wide rows) and runs the obj-only model
at hidden 4,096 with 32 heads (``--phases widths``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.ops import pallas_flash_attention as jax_flash
from structured_alignment_vqa_tpu.ops.pallas_attention_bwd import fused_attention_bwd
from structured_alignment_vqa_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1
from structured_alignment_vqa_tpu_torch.ops.dispatch import SMEM_LIMIT
from test_torch_port_widths import attention_inputs, close

DTYPES = (torch.float32, torch.bfloat16)
WIDE_C = (2049, 2056, 3000, 4096, 8192, 16384)
WIDE_HEADS = (257, 264, 320, 512, 1024, 2048)
K12_LENGTHS = (1, 16, 128, 450, 512)     # Tq and Tk of K1 and K2
FLASH_LENGTHS = (1, 1536)                # Tq of K4-K6 (1,536 keys)
K3_ROWS = (8, 4096, 57600)               # rows of K3: a few, the kernel rows, bs 128 x 450


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def wide_pairs():
    """(C, heads) above D: each sampled C at head width 128 (where it
    divides) and at one head, and each sampled head width at 1, 2 and 8
    heads."""
    pairs = {(c, c // 128) for c in WIDE_C if c % 128 == 0} | {(c, 1) for c in WIDE_C}
    pairs |= {(dh * h, h) for dh in WIDE_HEADS for h in (1, 2, 8)}
    return sorted(pairs)


def test_the_samples_lie_outside_the_old_domain():
    for c, heads in wide_pairs():
        assert c > 2048 or c // heads > 256
    assert (4096, 32) in wide_pairs() and (4096, 8) in wide_pairs()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k3_takes_c_and_hidden_widths_above_the_old_domain(dtype):
    """K3's three entries at each sampled C with hidden width 4C (and C 64
    with hidden 4 x 16,384): the check passes, the split covers the hidden
    chunks with no shard empty, f32 takes at most four shards above C
    2,048, and the products' shared memory fits."""
    for c, hd in [(c, 4 * c) for c in WIDE_C] + [(64, 4 * 16384)]:
        meta = dict(device="meta", dtype=dtype)
        x, w1, b1 = torch.empty(1, 8, c, **meta), torch.empty(hd, c, **meta), torch.empty(hd, **meta)
        w2, b2 = torch.empty(c, hd, **meta), torch.empty(c, **meta)
        gamma, beta = (torch.empty(c, device="meta") for _ in range(2))
        k3._check(x, w1, b1, w2, b2, gamma, beta)
        k3._check_partial(x, w1, b1, w2)
        k3._check_epilogue(torch.empty(1, 8, c, device="meta"), x, b2, gamma, beta)
        assert k3.ffn_path(dtype, c, hd) == "products"
        chunks = -(-hd // k3.HIDDEN_CHUNK)
        for rows in K3_ROWS:
            tile_rows, n_split, per = k3.products_plan(rows, c, hd, dtype)
            assert (n_split - 1) * per < chunks <= n_split * per
            assert k3.kernel_ffn_split(dtype, rows, c, hd) == (n_split, per)
            assert k3.smem_bytes_products(dtype, tile_rows) <= SMEM_LIMIT
            if dtype == torch.float32 and c > k3.LANE_MAX_C:
                assert n_split <= k3.MAX_WIDE_SHARDS


def test_k3_raises_only_past_its_32_bit_tile_offsets():
    x = torch.empty(1, 2, k3.MAX_WIDTH + 1, device="meta")
    w = torch.empty(4, k3.MAX_WIDTH + 1, device="meta")
    with pytest.raises(ValueError, match="128 rows of it within 2"):
        k3._check_partial(x, w, torch.empty(4, device="meta"), w.t())


def k1_need(dtype, tq, tk, c, heads):
    path = k1.k1_path(dtype, c // heads, tk, c)
    if path == "wide":
        return path, flash.smem_bytes_wide("K4")
    need = {"tensor-core": k1.smem_bytes_tc, "f32": k1.smem_bytes_f32,
            "simt": k1.smem_bytes}[path](tq, tk, c, heads)
    return path, need


def k2_need(dtype, tq, tk, c, heads):
    path = k1.k2_path(dtype, c // heads, tk, c, heads)
    if path == "wide":
        return path, max(flash.smem_bytes_wide(kn) for kn in ("K4", "K5", "K6"))
    if path == "tensor-core":
        return path, k1.smem_bytes_bwd_tc(tk, c, heads)
    if path == "f32":
        return path, k1.smem_bytes_bwd_f32(tq, c, heads)
    return path, k1.smem_bytes_bwd(tq, tk, c, heads)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_wrappers_take_c_and_head_widths_above_the_old_domain(dtype):
    """K1 and K2 (both entries) and K4-K6 at each sampled (C, heads) on
    (1, 8, C) tensors: the checks pass; K1's and K2's kernels fit at Tq, Tk
    in {1, 16, 128, 450, 512}, every head wider than 256 taking the wide
    path; K4-K6 take the wide kernels above 256, one shard, their shared
    memory the same at every head width, but for K4 in bf16 at multiples of
    16 and f32 at multiples of 4, which take its chunked tensor-core and f32
    kernels and their key splits."""
    km, qm, graph = torch.ones(1, 8), torch.ones(1, 8), torch.ones(1, 8, 8)
    for c, heads in wide_pairs():
        dh = c // heads
        q = torch.empty(1, 8, c, dtype=dtype, device="meta")
        gamma = beta = torch.empty(c, device="meta")
        km_, qm_, g_ = (t.to("meta") for t in (km, qm, graph))
        k1._check(q, q, q, km_, qm_, g_, q, gamma, beta, heads, "l1")
        k1._check(q, q, q, km_, qm_, g_, q, gamma, beta, heads, "l1", dy=q)
        k1._check(q, q, q, km_, qm_, g_, None, None, None, heads, "sum_eps")
        k1._check(q, q, q, km_, qm_, g_, None, None, None, heads, "sum_eps", q)
        stat = torch.empty(1, heads, 8, device="meta")
        flash._check(q, q, q, km_, g_, heads, "l1", {"query_mask": qm_})
        flash._check(q, q, q, km_, g_, heads, "l1",
                     {"m": stat, "z": stat, "b": stat, "delta": stat, "d_out": q})
        for tq in K12_LENGTHS:
            for tk in K12_LENGTHS:
                for need_of in (k1_need, k2_need):
                    path, need = need_of(dtype, tq, tk, c, heads)
                    assert need <= SMEM_LIMIT, (c, heads, tq, tk, path)
                    if dh > k1.SIMT_MAX_HEAD_DIM:
                        assert path == "wide"
            row_tile = k1.bwd_row_tile(dtype, dh, tq, 512, c, heads)
            assert 1 <= row_tile <= k1.BWD_F32_ROWS
        path = flash.k4_path(dtype, dh)
        assert flash.dq_kernel(dtype, dh) == flash.dkv_kernel(dtype, dh) == flash.k56_path(
            dtype, dh)
        if dh > k1.SIMT_MAX_HEAD_DIM:
            chunked = {torch.bfloat16: ("tc-chunked", 16), torch.float32: ("f32-chunked", 4)}
            name, multiple = chunked[dtype]
            assert path == (name if dh % multiple == 0 else "wide")
            assert flash.dq_kernel(dtype, dh) == "wide"
        steps = 1536 // (flash.f32_step(dh) if path.startswith("f32") else flash.KEY_STEP)
        for tq in FLASH_LENGTHS:
            n_split, per = flash.kernel_key_split(dtype, dh, 2, heads, tq, 1536)
            assert (n_split - 1) * per < steps <= n_split * per
            if path == "wide":
                assert n_split == 1 and flash.wide_chunks(dh) == -(-dh // 256)
    for kernel in ("K4", "K5", "K6"):
        assert flash.smem_bytes_wide(kernel) <= SMEM_LIMIT
    assert flash.smem_bytes_tc_chunked() <= SMEM_LIMIT
    assert flash.smem_bytes_f32_chunked() <= SMEM_LIMIT


def test_k1_paths_at_the_model_point():
    """C 4,096 with 32 heads of 128 keeps the tensor-core (bf16) and
    register-tiled (f32) K1 kernels, whose shared memory does not grow with
    C; K2 takes the composed route in bf16 (its tensor-core rows launch does
    not fit; the SIMT kernels it took before keep 8 rows a block) and its
    f32 kernels in f32."""
    for tk in (128, 450):
        assert k1.k1_path(torch.bfloat16, 128, tk, 4096) == "tensor-core"
        assert k1.k1_path(torch.float32, 128, tk, 4096) == "f32"
        assert k1.smem_bytes_tc(tk, tk, 4096, 32) == k1.smem_bytes_tc(tk, tk, 512, 4)
        assert k1.k2_path(torch.bfloat16, 128, tk, 4096, 32) == "composed"
        assert k1.k2_path(torch.float32, 128, tk, 4096, 32) == "f32"
        assert k1.simt_bwd_rows(tk, tk, 4096, 32) == 8


# ---- the plain versions at new widths against the JAX kernels ----------------

@pytest.mark.parametrize("c", [2056, 4096])
def test_k3_plain_matches_the_jax_kernel_above_the_old_domain(rng, c):
    """16 rows of C with hidden width 4C."""
    hd = 4 * c
    x = rng.standard_normal((2, 8, c), dtype=np.float32)
    w1 = rng.standard_normal((c, hd), dtype=np.float32) * np.float32(1 / np.sqrt(c))
    b1 = 0.1 * rng.standard_normal(hd, dtype=np.float32)
    w2 = rng.standard_normal((hd, c), dtype=np.float32) * np.float32(1 / np.sqrt(hd))
    b2 = 0.1 * rng.standard_normal(c, dtype=np.float32)
    gamma = 1 + 0.1 * rng.standard_normal(c, dtype=np.float32)
    beta = 0.1 * rng.standard_normal(c, dtype=np.float32)
    want = jax_fused_ffn(*map(jnp.asarray, (x, w1, b1, w2, b2, gamma, beta)))
    t = torch.from_numpy
    got = k3.ffn_ln_plain(t(x), t(w1).t(), t(b1), t(w2).t(), t(b2), t(gamma), t(beta))
    close(got, want, f"K3 C={c}")


# (C, heads): head widths 512 and 320
WIDE_HEAD_PAIRS = [(1024, 2), (640, 2)]


@pytest.mark.parametrize("c,heads", WIDE_HEAD_PAIRS, ids=str)
def test_k1_k2_plain_match_the_jax_kernels_above_the_old_domain(rng, c, heads):
    """K1's and K2's plain versions against the JAX K1 and K2 in interpret
    mode, B 2, L 9, both renorms."""
    args, dy = attention_inputs(rng, 2, 9, c)
    t = [torch.from_numpy(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    for renorm in k1.RENORMS:
        want = pa.fused_graph_attention_ln(*j, heads, renorm)
        close(k1.graph_attention_ln_plain(*t, heads, renorm), want, f"K1 {c}/{heads} {renorm}")
        want = fused_attention_bwd(*j, jnp.asarray(dy), heads, renorm, interpret=True)
        got = k1.graph_attention_ln_bwd_plain(*t, torch.from_numpy(dy), heads, renorm)
        for name, g, w in zip(("dq", "dk", "dv", "dresidual", "dgamma", "dbeta"), got, want):
            close(g, w, f"K2 {c}/{heads} {renorm} {name}")


@pytest.mark.parametrize("c,heads", WIDE_HEAD_PAIRS, ids=str)
def test_k4_k5_k6_plain_match_the_jax_kernels_above_the_old_domain(rng, c, heads):
    """K4's plain output and K5's and K6's plain gradients (of sum(out w))
    against the JAX K4 and jax.grad through its K5 and K6, interpret mode,
    9 queries into 13 keys: l1 at head width 512, sum_eps at 320."""
    args, _ = attention_inputs(rng, 2, 13, c)
    q, k, v, km = args[:4]
    q = q[:, :9]
    qm = (rng.random((2, 9)) > 0.15).astype(np.float32)
    graph = (rng.random((2, 9, 13)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    w = rng.standard_normal((2, 9, c)).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, k, v, km, qm, graph)]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, km, qm, graph)]
    for renorm in ("l1" if c // heads == 512 else "sum_eps",):
        def loss(q_, k_, v_):
            out = jax_flash.flash_graph_attention(q_, k_, v_, *j[3:], heads, renorm, 8, 8, True)
            return jnp.sum(out * w), out

        (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*j[:3])
        out, m, z, bsum = flash.flash_graph_attention_plain(*t, heads, renorm, "stats")
        close(out, want_out, f"K4 {c}/{heads} {renorm}")
        got = flash.flash_graph_attention_bwd_plain(*t, out, m, z, bsum, torch.from_numpy(w),
                                                    heads, renorm)
        for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
            close(g, wnt, f"K5/K6 {c}/{heads} {renorm} {name}")
