"""The widths the port's kernels take, over the domain D the kernels were
first widened to.

D: C (the hidden width) from 1 to 2,048, every head count whose head width
C / heads is from 1 to 256, the FFN hidden width up to 4 x 2,048, both
dtypes, at every length the attention modules send each kernel (K1 and K2
up to 512 keys, K4-K6 above). The kernels now take every width above D too
(``tests/test_torch_port_widths_wide.py`` samples them). On the CPU no
kernel launches, so this file holds what decides a launch on the card:

* every wrapper's check takes every (C, heads) of D on small CPU tensors
  (B 1, L 8), and just outside D takes the width too, its plan and shared
  memory fitting;
* every plan and shared-memory formula a call of D takes is a pure function
  of the shapes that fits the shared memory a block may use, at the
  lengths each kernel sees;
* the plain versions at the new widths (C 384 and 768, head widths 256 and
  50) against the JAX kernels in Pallas interpret mode, within 1e-5;
* the port's entry points run on the card unless the caller asks for the CPU.

``chip_smoke.py`` holds each kernel against these plain versions on the card
at the new widths (its kernel phases' rows marked wide) and runs the
obj-only model at hidden 768 with 12 heads (``--phases widths``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.ops import pallas_flash_attention as jax_flash
from structured_alignment_vqa_tpu.ops.pallas_attention_bwd import fused_attention_bwd
from structured_alignment_vqa_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1
from structured_alignment_vqa_tpu_torch.ops.dispatch import SMEM_LIMIT

MAX_C, MAX_HEAD, MAX_HIDDEN = 2048, 256, 4 * 2048
DTYPES = (torch.float32, torch.bfloat16)
L = 8                                   # the sweep's sequence length
K12_LENGTHS = (1, 16, 128, 450, 512)    # Tq and Tk of K1 and K2 in the formulas' sweep
FLASH_L = 1600                          # K4-K6's length in the formulas' sweep
JAX_TOL = 1e-5                          # the kernels' plain versions against the JAX kernels


def domain():
    """Every (C, heads) of D."""
    return [(c, h) for c in range(1, MAX_C + 1) for h in range(1, c + 1)
            if c % h == 0 and c // h <= MAX_HEAD]


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def views(buf, *shapes):
    """Contiguous tensors of ``shapes`` over one buffer (the checks read
    shapes, dtypes and devices, not values)."""
    return [buf[:int(np.prod(s))].view(*s) for s in shapes]


def test_the_domain_is_what_it_says():
    pairs = domain()
    assert (1, 1) in pairs and (2048, 8) in pairs and (768, 12) in pairs and (300, 6) in pairs
    assert (2048, 4) not in pairs and (512, 1) not in pairs
    assert len({c for c, _ in pairs}) == MAX_C


# ---- every width of D passes the wrappers' checks ---------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k3_takes_every_c_and_hidden_width_of_the_domain(dtype):
    """K3's three entries (the FFN, the model axis's partial and epilogue)
    at every C from 1 to 2,048 with the model's 4C hidden width, and each
    call's plan: a split that covers the hidden chunks with no shard empty
    and shared memory that fits."""
    buf = torch.zeros(4 * MAX_C * MAX_C, dtype=dtype)
    f32 = torch.zeros(4 * MAX_C * L, dtype=torch.float32)
    for c in range(1, MAX_C + 1):
        hd = 4 * c
        x, w1, b1, w2, b2 = views(buf, (1, L, c), (hd, c), (hd,), (c, hd), (c,))
        gamma, beta, y = views(f32, (c,), (c,), (1, L, c))
        k3._check(x, w1, b1, w2, b2, gamma, beta)
        k3._check_partial(x, w1, b1, w2)
        k3._check_epilogue(y, x, b2, gamma, beta)
        chunks = -(-hd // k3.HIDDEN_CHUNK)
        for rows in (L, 16384):
            n_split, per = k3.kernel_ffn_split(dtype, rows, c, hd)
            assert n_split >= 1 and per >= 1 and (n_split - 1) * per < chunks <= n_split * per
            if k3.ffn_path(dtype, c, hd) == "row-tile":
                assert c in k3.ROW_TILE_WIDTHS and k3.smem_bytes_tc(c) <= SMEM_LIMIT
            else:
                tile_rows = k3.products_plan(rows, c, hd, dtype)[0]
                assert tile_rows in ((64, 128) if dtype == torch.float32 else (128,))
                assert k3.smem_bytes_products(dtype, tile_rows) <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_wrappers_take_every_c_and_head_width_of_the_domain(dtype):
    """K1 and K2 (both entries each) and K4-K6 at every (C, heads) of D on
    (1, 8, C) tensors."""
    buf = torch.zeros(L * MAX_C, dtype=dtype)
    f32 = torch.zeros(L * MAX_C, dtype=torch.float32)
    km, qm = torch.ones(1, L), torch.ones(1, L)
    graph = torch.ones(1, L, L)
    pairs = domain()
    for c in sorted({c for c, _ in pairs}):
        q, = views(buf, (1, L, c))
        gamma, beta = views(f32, (c,), (c,))
        for heads in (h for cc, h in pairs if cc == c):
            k1._check(q, q, q, km, qm, graph, q, gamma, beta, heads, "l1")
            k1._check(q, q, q, km, qm, graph, q, gamma, beta, heads, "l1", dy=q)
            k1._check(q, q, q, km, qm, graph, None, None, None, heads, "sum_eps")
            k1._check(q, q, q, km, qm, graph, None, None, None, heads, "sum_eps", q)
            stat, = views(f32, (1, heads, L))
            flash._check(q, q, q, km, graph, heads, "l1", {"query_mask": qm})
            flash._check(q, q, q, km, graph, heads, "l1",
                         {"m": stat, "z": stat, "b": stat, "delta": stat, "d_out": q})


# ---- just outside D the wrappers take the width too ----------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c,heads,match", [(2056, 8, "wide"), (528, 2, "wide")])
def test_attention_wrappers_raise_just_outside_the_domain(dtype, c, heads, match):
    """Just outside D (C 2,056 at 8 heads of 257; 2 heads of 264) every
    attention wrapper takes the width: the calls take the ``match`` path
    (the wide kernels; K4 at 264, a multiple of 4, its chunked f32 kernel
    in f32), whose shared memory fits a block at every length."""
    q = torch.zeros(1, L, c, dtype=dtype)
    km, qm, graph = torch.ones(1, L), torch.ones(1, L), torch.ones(1, L, L)
    gamma, beta = torch.ones(c), torch.zeros(c)
    stat = torch.zeros(1, heads, L)
    k1._check(q, q, q, km, qm, graph, q, gamma, beta, heads, "l1")
    k1._check(q, q, q, km, qm, graph, q, gamma, beta, heads, "l1", dy=q)
    k1._check(q, q, q, km, qm, graph, None, None, None, heads, "l1", q)
    flash._check(q, q, q, km, graph, heads, "l1", {"query_mask": qm})
    flash._check(q, q, q, km, graph, heads, "l1",
                 {"m": stat, "z": stat, "b": stat, "delta": stat, "d_out": q})
    dh = c // heads
    for tk in K12_LENGTHS:
        assert k1.k1_path(dtype, dh, tk, c) == k1.k2_path(dtype, dh, tk, c, heads) == match
    assert flash.dq_kernel(dtype, dh) == match
    chunked = dtype == torch.float32 and dh % 4 == 0
    assert flash.k4_path(dtype, dh) == ("f32-chunked" if chunked else match)
    split = flash.kernel_key_split(dtype, dh, 1, heads, FLASH_L, FLASH_L)
    if chunked:   # a block per head and chunk of 128 rows: 52 blocks, under the card's 132
        plan = flash.f32_plan(1, heads * flash.wide_chunks(dh), FLASH_L, FLASH_L, 32, 128)
        assert split == plan[1:] == flash.k4_f32_plan(dh, 1, heads, FLASH_L, FLASH_L)[1:]
        assert split[0] > 1
    else:
        assert split[0] == 1
    assert max(flash.smem_bytes_wide(kn) for kn in ("K4", "K5", "K6")) <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c,hidden,match", [(2056, 4 * 2056, "products"),
                                            (16, MAX_HIDDEN + 64, "products")])
def test_k3_raises_just_outside_the_domain(dtype, c, hidden, match):
    """Just outside D (C 2,056 with its 4C hidden width; a hidden width of
    8,256) K3's three entries take the width, on the products path, with a
    split that covers the hidden chunks and shared memory that fits."""
    x = torch.zeros(1, L, c, dtype=dtype)
    w1, b1 = torch.zeros(hidden, c, dtype=dtype), torch.zeros(hidden, dtype=dtype)
    w2, b2 = torch.zeros(c, hidden, dtype=dtype), torch.zeros(c, dtype=dtype)
    gamma, beta = torch.ones(c), torch.zeros(c)
    k3._check(x, w1, b1, w2, b2, gamma, beta)
    k3._check_partial(x, w1, b1, w2)
    k3._check_epilogue(torch.zeros(1, L, c), x, b2, gamma, beta)
    assert k3.ffn_path(dtype, c, hidden) == match
    chunks = -(-hidden // k3.HIDDEN_CHUNK)
    for rows in (L, 16384):
        tile_rows, n_split, per = k3.products_plan(rows, c, hidden, dtype)
        assert (n_split - 1) * per < chunks <= n_split * per
        assert k3.smem_bytes_products(dtype, tile_rows) <= SMEM_LIMIT


# ---- the plans and shared memory of every call of D ---------------------------

def k1_smem(dtype, tq, tk, c, heads):
    path = k1.k1_path(dtype, c // heads)
    if path == "tensor-core":
        return k1.smem_bytes_tc(tq, tk, c, heads)
    if path == "f32":
        return k1.smem_bytes_f32(tq, tk, c, heads)
    return k1.smem_bytes(tq, tk, c, heads)


def k2_smem(dtype, tq, tk, c, heads):
    path = k1.k2_path(dtype, c // heads, tk, c, heads)
    if path == "tensor-core":
        return k1.smem_bytes_bwd_tc(tk, c, heads)
    if path == "f32":
        return k1.smem_bytes_bwd_f32(tq, c, heads)
    return k1.smem_bytes_bwd(tq, tk, c, heads)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k1_k2_shared_memory_fits_every_call_of_the_domain(dtype):
    """K1's and K2's kernels at every (C, heads) of D and Tq, Tk in {1, 16,
    128, 450, 512}: the shared memory of the path each call takes fits a
    block, and K2's row tile cuts the query rows into whole partials."""
    worst = 0
    for c, heads in domain():
        dh = c // heads
        for tq in K12_LENGTHS:
            for tk in K12_LENGTHS:
                worst = max(worst, k1_smem(dtype, tq, tk, c, heads),
                            k2_smem(dtype, tq, tk, c, heads))
            row_tile = k1.bwd_row_tile(dtype, dh, tq, K12_LENGTHS[-1], c, heads)
            assert 1 <= row_tile <= max(k1.BWD_F32_ROWS, k1.BWD_TC_ROWS)
    assert worst <= SMEM_LIMIT
    # the widest head at the most keys: 8 rows a block of the SIMT kernels
    assert k1.simt_rows(512, 512, 2048, 8) == 8 and k1.simt_bwd_rows(512, 512, 2048, 8) == 8
    assert k1.simt_rows(128, 128, 512, 8) == 16 and k1.simt_bwd_rows(9, 9, 512, 8) == 9


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k4_k5_k6_plans_and_shared_memory_fit_every_head_width(dtype):
    """K4-K6 at L 1,600 and every head width of D, one or all query tiles:
    the key split covers the key steps with no shard empty, and the shared
    memory of the kernel each call takes fits a block (the tensor-core
    kernels' is fixed by their instances: 16-256). K5 and K6 keep their own
    paths, the same for both."""
    for c, heads in domain():
        dh = c // heads
        path = flash.k4_path(dtype, dh)
        assert flash.dq_kernel(dtype, dh) == flash.dkv_kernel(dtype, dh) == flash.k56_path(
            dtype, dh)
        step = flash.f32_step(dh) if path == "f32" else flash.KEY_STEP
        steps = -(-FLASH_L // step)
        for tq in (1, FLASH_L):
            n_split, per = flash.kernel_key_split(dtype, dh, 1, heads, tq, FLASH_L)
            assert (n_split - 1) * per < steps <= n_split * per
            if path == "simt":
                assert n_split == 1
    for dh in range(1, MAX_HEAD + 1):
        path, k56 = flash.k4_path(dtype, dh), flash.k56_path(dtype, dh)
        need = [flash.smem_bytes_f32(dh, 64)] if path == "f32" else []
        if path == "simt":
            need.append(flash.smem_bytes_simt("K4", dh))
        if path == "tensor-core":
            assert dh % 16 == 0
            need.append(flash.smem_bytes_tc(dh))
        if k56 == "f32":
            need += [flash.smem_bytes_dq_f32(dh, 64), flash.smem_bytes_dkv_f32(dh)]
        elif k56 == "simt":
            need += [flash.smem_bytes_simt(kernel, dh) for kernel in ("K5", "K6")]
        else:
            assert dh % 16 == 0 and dh <= 256
            need += [flash.smem_bytes_k56_tc(kernel, dh) for kernel in ("K5", "K6")]
        assert max(need) <= SMEM_LIMIT, (dh, path, need)
    assert flash.simt_rows(128) == 64 and flash.simt_rows(129) == 32


# ---- the plain versions at the new widths against the JAX kernels --------------

def close(got, want, name, tol=JAX_TOL):
    """|got - want| <= tol times max(1, the largest |want|)."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert np.isfinite(got).all() and err <= tol, (name, err)


@pytest.mark.parametrize("c", [384, 768])
def test_k3_plain_matches_the_jax_kernel_at_new_widths(rng, c):
    hd = 4 * c
    x = rng.standard_normal((2, 5, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hd)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hd)).astype(np.float32)
    w2 = (rng.standard_normal((hd, c)) / np.sqrt(hd)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    want = jax_fused_ffn(*map(jnp.asarray, (x, w1, b1, w2, b2, gamma, beta)))
    t = torch.from_numpy
    got = k3.ffn_ln_plain(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2), t(gamma), t(beta))
    close(got, want, f"K3 C={c}")


def attention_inputs(rng, b, l, c):
    """K1's arguments and dy as float32 numpy arrays: padding keys, padded
    queries and a row with no neighbour."""
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    x[0, -2:] = 0.0
    res = rng.standard_normal((b, l, c)).astype(np.float32)
    q = np.maximum(res * 0.5 + 0.1, 0).astype(np.float32)
    k = np.maximum(x * 0.3 - 0.05, 0).astype(np.float32)
    v = np.maximum(x, 0).astype(np.float32)
    km = (np.abs(x.sum(-1)) > 0).astype(np.float32)
    qm = (rng.random((b, l)) > 0.15).astype(np.float32)
    graph = (rng.random((b, l, l)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, l, c)).astype(np.float32)
    return (q, k, v, km, qm, graph, res, gamma, beta), dy


# (C, heads): C 384 and 768 at head width 64, head widths 256 and 50
NEW_WIDTHS = [(384, 6), (768, 12), (512, 2), (300, 6)]


@pytest.mark.parametrize("c,heads", NEW_WIDTHS, ids=str)
def test_k1_k2_plain_match_the_jax_kernels_at_new_widths(rng, c, heads):
    """K1's and K2's plain versions against the JAX K1
    (``fused_graph_attention_ln``) and K2 (``fused_attention_bwd``) in
    interpret mode: l1 at the head width 64 widths, both renorms at the
    others."""
    args, dy = attention_inputs(rng, 2, 9, c)
    t = [torch.from_numpy(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    for renorm in ("l1",) if c // heads == 64 else k1.RENORMS:
        want = pa.fused_graph_attention_ln(*j, heads, renorm)
        close(k1.graph_attention_ln_plain(*t, heads, renorm), want, f"K1 {c}/{heads} {renorm}")
        want = fused_attention_bwd(*j, jnp.asarray(dy), heads, renorm, interpret=True)
        got = k1.graph_attention_ln_bwd_plain(*t, torch.from_numpy(dy), heads, renorm)
        for name, g, w in zip(("dq", "dk", "dv", "dresidual", "dgamma", "dbeta"), got, want):
            close(g, w, f"K2 {c}/{heads} {renorm} {name}")


@pytest.mark.parametrize("c,heads", NEW_WIDTHS[2:], ids=str)
def test_k4_k5_k6_plain_match_the_jax_kernels_at_new_widths(rng, c, heads):
    """K4's plain output and K5's and K6's plain gradients (of sum(out w))
    against the JAX K4 and jax.grad through its K5 and K6, interpret mode,
    9 queries into 13 keys."""
    args, _ = attention_inputs(rng, 2, 13, c)
    q, k, v, km, _, _, _, _, _ = args
    q = q[:, :9]
    qm = (rng.random((2, 9)) > 0.15).astype(np.float32)
    graph = (rng.random((2, 9, 13)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    w = rng.standard_normal((2, 9, c)).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, k, v, km, qm, graph)]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, km, qm, graph)]
    for renorm in flash.RENORMS:
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


# ---- the entry points run on the card unless the caller asks for the CPU ------

def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument the model, the synthetic batches, the CLIs'
    device and the dry run take the CUDA card, and raise where there is
    none; ``device="cpu"`` (``--platform cpu``, ``--device cpu``) is the CPU."""
    from types import SimpleNamespace

    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
    from structured_alignment_vqa_tpu_torch.parallel import dryrun
    from structured_alignment_vqa_tpu_torch.train.main import device_from_args

    cfg = ModelConfig(num_classes=4, vocab_size=300, hidden_size=16, num_heads=2, num_blocks=2,
                      stage1_blocks=1, stage2_blocks=2, glove_dim=8, hidden_size_mil=16,
                      vis_fea_dim=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: AttModelX3(cfg), lambda: synthetic_batch(cfg, 2),
                 lambda: device_from_args(SimpleNamespace(platform=None)),
                 lambda: dryrun.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert device_from_args(SimpleNamespace(platform="cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_from_args(SimpleNamespace(platform=None)) == torch.device("cuda")
