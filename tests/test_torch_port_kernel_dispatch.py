"""What surrounds the port's tensor-core kernels (K1, K2, K3, K4's forward)
and runs on the CPU: the merge of K4's key shards, the rules that pick a
kernel, a key split or a hidden-width split, the shared-memory and scratch
shapes, the sum of K3's hidden-width shards, and the rounding points K2's
plain version shares with its tensor-core kernels.

The merge: ``merge_partials_plain`` over 2, 3 and 5 key shards of
``flash_graph_attention_plain(..., emit="partial")`` against the unsplit
call, and against a fold of the JAX package's ``ring_attention._merge``; all
float32, 1e-6 of each output's largest magnitude (sums in another order).
The shards K4's float32 kernel cuts (``f32_plan``: 256 keys a shard) are
held, merged, to the unsplit plain call and to the JAX package's
``flash_graph_attention`` in interpret mode within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.ops.pallas_attention_bwd import fused_attention_bwd
from structured_alignment_vqa_tpu.ops.pallas_flash_attention import (
    flash_graph_attention as jax_flash_graph_attention,
)
from structured_alignment_vqa_tpu.ops.ring_attention import _merge as jax_merge
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as k3
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

TOL = 1e-6
HEADS = 2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def flash_inputs(rng, b=2, tq=7, tk=40, c=16):
    """K4's arguments, float32: sample 0 has every key of the second shard
    of five (keys 8-15) masked, sample 1 row 0 has an all-zero graph (a dead
    row), row 1 of sample 0 (row 0 when it is the only one) is a padded
    query."""
    q, k, v = (torch.from_numpy(np.maximum(rng.standard_normal((b, t, c)), 0).astype(np.float32))
               for t in (tq, tk, tk))
    key_mask = torch.from_numpy((rng.random((b, tk)) > 0.2).astype(np.float32))
    key_mask[0, 8:16] = 0.0
    query_mask = torch.ones(b, tq)
    query_mask[0, min(1, tq - 1)] = 0.0
    graph = torch.from_numpy((rng.random((b, tq, tk)) > 0.5).astype(np.float32))
    graph[1, 0] = 0.0
    return q, k, v, key_mask, query_mask, graph


def shard_partials(args, bounds):
    """``emit="partial"`` of each key range [lo, hi), stacked; an empty range
    is a shard that saw no key: a = z = b = 0, m = -inf."""
    q, k, v, key_mask, query_mask, graph = args
    parts = []
    for lo, hi in bounds:
        if lo == hi:
            b, tq, c = q.shape
            zero = torch.zeros(b, HEADS, tq)
            parts.append((torch.zeros(b, HEADS, tq, c // HEADS), zero - float("inf"), zero, zero))
        else:
            parts.append(flash.flash_graph_attention_plain(
                q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(),
                key_mask[:, lo:hi].contiguous(), query_mask, graph[:, :, lo:hi].contiguous(),
                HEADS, "l1", "partial"))
    return tuple(torch.stack(x) for x in zip(*parts))


def close(got, want, name, tol=TOL):
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (name, err, scale)


SHARDS = {2: ((0, 24), (24, 40)), 3: ((0, 8), (8, 16), (16, 40)),
          5: ((0, 8), (8, 16), (16, 24), (24, 32), (32, 40)),
          "empty": ((0, 16), (16, 16), (16, 40))}
# (Tq, Tk) whose keys K4's float32 kernel splits at the obj+rel point (B 4, 8
# heads): the decoder's one query into 1,536 keys (6 shards of 4 steps), two
# query tiles into 1,536 (6) and Tq 200 into 700 keys (3, the last ragged)
F32_SHARDS = {"f32 Tq=1 Tk=1536": (1, 1536), "f32 Tq=70 Tk=1536": (70, 1536),
              "f32 Tq=200 Tk=700": (200, 700)}
F32_TOL = 1e-5


def f32_bounds(tq: int, tk: int) -> tuple:
    """The key ranges of ``f32_plan``'s shards at B 4, 8 heads."""
    _, n_split, per = flash.f32_plan(4, 8, tq, tk)
    keys = per * flash.KEY_STEP
    return tuple((i * keys, min(tk, (i + 1) * keys)) for i in range(n_split))


@pytest.mark.parametrize("renorm", flash.RENORMS)
@pytest.mark.parametrize("shards", list(SHARDS) + list(F32_SHARDS), ids=str)
def test_merged_shards_equal_the_unsplit_call(rng, shards, renorm):
    """Shard 2 of 3 and of 5 is fully masked in sample 0 (its m is the fill
    value and the merge wipes it); "empty" holds a shard that saw no key.
    The f32 kernel's shards: merged, against the unsplit call and against
    the JAX package's K4 in interpret mode."""
    if shards in F32_SHARDS:
        tq, tk = F32_SHARDS[shards]
        args, bounds, tol = flash_inputs(rng, tq=tq, tk=tk), f32_bounds(tq, tk), F32_TOL
        assert len(bounds) > 1 and bounds[-1][1] == tk
    else:
        args, bounds, tol = flash_inputs(rng), SHARDS[shards], TOL
    a, m, z, bsum = flash.merge_partials_plain(*shard_partials(args, bounds))
    want = flash.flash_graph_attention_plain(*args, HEADS, renorm, "partial")
    for name, g, w in zip(("a", "m", "z", "b"), (a, m, z, bsum), want):
        close(g, w, name, tol)
    assert float(bsum[1, :, 0].abs().max()) == 0.0          # the dead row stays dead
    out = flash._renormalise(a, z, bsum, args[4], renorm, torch.float32)
    close(out, flash.flash_graph_attention_plain(*args, HEADS, renorm), "out", tol)
    padded = (0, min(1, args[0].shape[1] - 1))
    assert float(out[padded].abs().max()) == 0.0 and float(out[1, 0].abs().max()) == 0.0
    if shards in F32_SHARDS:
        jax_out = jax_flash_graph_attention(*(jnp.asarray(t.numpy()) for t in args), HEADS,
                                            renorm, 8, 256, True)
        close(out, torch.from_numpy(np.array(jax_out)), "out against JAX", tol)


def test_merge_of_empty_shards_only_is_empty():
    a, m, z, bsum = flash.merge_partials_plain(
        torch.zeros(2, 1, 1, 3, 4), torch.full((2, 1, 1, 3), -float("inf")),
        torch.zeros(2, 1, 1, 3), torch.zeros(2, 1, 1, 3))
    assert torch.isinf(m).all() and not torch.isnan(a).any()
    assert float(z.abs().max()) == 0.0 and float(bsum.abs().max()) == 0.0


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_merge_matches_the_jax_ring_merge(rng, n_shards):
    """numpy inputs from a seed through both merges: the port's in one
    N-way step, the JAX package's pairwise, folded over the shards."""
    shape = (n_shards, 2, HEADS, 5)
    m = rng.standard_normal(shape).astype(np.float32) * 3
    m[0, 0, 0, 0] = -(2.0 ** 32)                 # a fully masked shard
    z = rng.random(shape).astype(np.float32) + 0.5
    bsum = rng.random(shape).astype(np.float32)
    a = rng.standard_normal(shape + (4,)).astype(np.float32)
    got = flash.merge_partials_plain(*(torch.from_numpy(x) for x in (a, m, z, bsum)))
    # _merge broadcasts its factors over a's last axis: stats carry a trailing 1
    acc = tuple(jnp.asarray(x[0])[..., None] for x in (m, z, bsum)) + (jnp.asarray(a[0]),)
    for i in range(1, n_shards):
        acc = jax_merge(*acc, *(jnp.asarray(x[i])[..., None] for x in (m, z, bsum)),
                        jnp.asarray(a[i]))
    want = (acc[3], acc[0][..., 0], acc[1][..., 0], acc[2][..., 0])
    for name, g, w in zip(("a", "m", "z", "b"), got, want):
        close(g, torch.from_numpy(np.array(w)), name)


@pytest.mark.parametrize("batch,heads,tq,tk,want", [
    (4, 8, 1, 1536, (8, 3)),        # the decoder's one query: 32 blocks -> 256
    (4, 8, 70, 1536, (5, 5)),       # two q-tiles, still under the card
    (4, 8, 1536, 1536, (1, 24)),    # the encoder: 768 blocks, no split
    (1, 1, 1, 64, (1, 1)),          # one step cannot be split
    (1, 1, 1, 6400, (100, 1)),      # never more shards than steps
    (4, 8, 200, 700, (3, 4)),
])
def test_key_split_is_a_pure_function_of_the_shapes(batch, heads, tq, tk, want):
    assert flash.key_split(batch, heads, tq, tk) == want
    assert flash.key_split(batch, heads, tq, tk) == want        # and says so twice


@pytest.mark.parametrize("tk", [1, 63, 64, 65, 700, 1536, 4096])
@pytest.mark.parametrize("blocks", [(1, 1, 1), (4, 8, 1), (2, 8, 100), (16, 8, 64)])
def test_key_split_leaves_no_shard_empty(blocks, tk):
    batch, heads, tq = blocks
    n_split, per = flash.key_split(batch, heads, tq, tk)
    steps = -(-tk // flash.KEY_STEP)
    assert n_split >= 1 and per >= 1
    assert (n_split - 1) * per < steps <= n_split * per          # the kernel's own guard
    if batch * heads * -(-tq // flash.TC_Q_TILE) >= flash.SM_COUNT:
        assert n_split == 1


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "tensor-core"), (torch.bfloat16, 16, "tensor-core"),
    (torch.bfloat16, 48, "tensor-core"), (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 40, "simt"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 144, "simt"), (torch.bfloat16, 256, "simt"),
])
def test_k4_kernel_path(dtype, head_dim, want):
    """f32 runs on the CUDA cores (TF32 would break 1e-4), in its own
    register-tiled kernel; a bf16 head width that is no multiple of 16 keeps
    the first SIMT kernel. The shared ``kernel_path`` (K2's, K5's, K6's)
    stops at 128; K4's own ``k4_path`` takes bf16 on the tensor cores at
    every multiple of 16 up to 256."""
    assert flash.kernel_path(dtype, head_dim) == want
    k4 = flash.k4_path(dtype, head_dim)
    if dtype == torch.bfloat16:
        assert k4 == ("tensor-core" if head_dim % 16 == 0 else "simt")
    else:
        assert k4 == "f32"


@pytest.mark.parametrize("batch,heads,tq,tk,want", [
    (4, 8, 1536, 1536, (64, 1, 24)),   # the encoder: 768 blocks, no split
    (4, 4, 1536, 1536, (64, 1, 24)),   # a model rank's 4 heads: 384 blocks
    (4, 8, 768, 768, (64, 1, 12)),     # the ring's shard
    (4, 8, 1, 1536, (16, 6, 4)),       # the decoder's one query: 32 blocks of one warp -> 192
    (4, 4, 1, 1536, (16, 6, 4)),       # ... on 4 heads: the same shards
    (4, 8, 70, 1536, (64, 6, 4)),      # two query tiles
    (4, 8, 200, 700, (64, 3, 4)),      # 128 blocks: under the card, a ragged last shard
    (1, 1, 1, 64, (16, 1, 1)),         # one step cannot be split
    (1, 1, 1, 130, (16, 1, 3)),        # three steps: one shard of them all
    (64, 8, 16, 300, (16, 1, 5)),      # 512 blocks of 16 rows
])
def test_f32_plan_is_a_pure_function_of_the_shapes(batch, heads, tq, tk, want):
    """K4's float32 kernel: rows a block, then shards of four key steps when
    the blocks do not cover the card, whatever the head count."""
    assert flash.f32_plan(batch, heads, tq, tk) == want
    assert flash.kernel_key_split(torch.float32, 64, batch, heads, tq, tk) == want[1:]


@pytest.mark.parametrize("tk", [1, 63, 64, 65, 256, 257, 700, 1536, 4096])
@pytest.mark.parametrize("blocks", [(1, 1, 1), (4, 8, 1), (4, 4, 1), (2, 8, 100), (16, 8, 64),
                                    (4, 8, 1536)])
def test_f32_key_split_leaves_no_shard_empty(blocks, tk):
    batch, heads, tq = blocks
    q_tile, n_split, per = flash.f32_plan(batch, heads, tq, tk)
    steps = -(-tk // flash.KEY_STEP)
    assert q_tile == (16 if tq <= 16 else 64)
    assert n_split >= 1 and per >= 1
    assert (n_split - 1) * per < steps <= n_split * per          # the kernel's own guard
    if batch * heads * -(-tq // q_tile) >= flash.SM_COUNT:
        assert n_split == 1
    else:
        assert per == min(flash.F32_SPLIT_STEPS, steps)
    # K5's f32 kernel splits by its own plan (key steps of 32)
    assert flash.dq_key_split(torch.float32, 64, batch, heads, tq, tk) == flash.dq_f32_plan(
        batch, heads, tq, tk)[1:]


@pytest.mark.parametrize("head_dim,q_tile,blocks_an_sm", [
    (64, 64, 2), (64, 16, 2), (32, 64, 3), (48, 64, 2), (128, 64, 1), (128, 16, 1),
])
def test_k4_f32_shared_memory_fits(head_dim, q_tile, blocks_an_sm):
    """One block of K4's f32 kernel fits the 227 KB a block may use, and at
    the model's head width of 64 two blocks (8 warps) share an SM, each
    paying 1 KB of reserve."""
    need = flash.smem_bytes_f32(head_dim, q_tile)
    assert blocks_an_sm * (need + 1024) <= k1.SMEM_LIMIT < (blocks_an_sm + 1) * (need + 1024)
    assert flash.smem_bytes_f32(64, 64) == 4 * (64 * 64 + 2 * (2 * 64 * 64 + 64 * 64 + 64))


@pytest.mark.parametrize("dtype,head_dim,tq,want,tile", [
    (torch.bfloat16, 64, 128, "tensor-core", 32), (torch.bfloat16, 64, 66, "tensor-core", 32),
    (torch.bfloat16, 48, 16, "tensor-core", 32), (torch.bfloat16, 64, 1, "tensor-core", 32),
    (torch.bfloat16, 24, 128, "simt", 16), (torch.bfloat16, 8, 1, "simt", 1),
    (torch.float32, 64, 128, "simt", 64), (torch.float32, 64, 9, "simt", 64),
])
def test_k2_kernel_path_and_row_tile(dtype, head_dim, tq, want, tile):
    """The row tile sets the number of dgamma/dbeta partials the rows launch
    (in f32 its LayerNorm backward) writes, so the wrapper alone
    decides the path and tells the kernel."""
    assert k1.kernel_path(dtype, head_dim) == want
    assert k1.bwd_row_tile(dtype, head_dim, tq) == tile


@pytest.mark.parametrize("c,heads,tq", [(512, 8, 128), (512, 8, 1), (512, 8, 300), (256, 4, 128),
                                        (512, 4, 66), (2048, 16, 64), (1024, 8, 16)])
def test_k2_f32_shared_memory_fits(c, heads, tq):
    """Every f32 kernel of K2 fits the 227 KB a block may use, the largest
    at the model's widths being the forward (K4's f32 body)."""
    need = k1.smem_bytes_bwd_f32(tq, c, heads)
    assert need <= k1.SMEM_LIMIT
    if c // heads == 64 and tq > 16:
        assert need == 4 * (64 * 64 + 2 * (2 * 64 * 64 + 64 * 64 + 64))


@pytest.mark.parametrize("c,heads,match", [(24, 4, "simt"), (4096, 32, "f32"),
                                           (2056, 8, "wide"), (528, 2, "wide")])
def test_k2_f32_refuses_what_its_kernels_do_not_take(c, heads, match):
    """Every width is taken before a launch, each by the design ``match``
    names: a head width that is no multiple of 4 (6 here) by the SIMT
    kernels, C 4,096 at head width 128 by the f32 kernels (their LayerNorm
    backward the one that reads rows in chunks), heads wider than 256 (257
    at C 2,056, 264) by the wide path; the shared memory fits."""
    x = torch.zeros(1, 8, c)
    args = (x, x, x, torch.ones(1, 8), torch.ones(1, 8), torch.ones(1, 8, 8), x,
            torch.ones(c), torch.zeros(c), heads, "l1")
    k1._check(*args, dy=x)
    assert k1.k2_path(torch.float32, c // heads, 8, c, heads) == match
    if match == "f32":
        assert k1.smem_bytes_bwd_f32(8, c, heads) <= k1.SMEM_LIMIT
        assert k1.bwd_row_tile(torch.float32, c // heads, 8, 8, c, heads) == k1.BWD_F32_ROWS


def test_k2_tensor_core_shared_memory_leaves_two_blocks_an_sm():
    """At the model's shapes (C 512, 8 heads, up to 128 keys) two blocks of
    the rows launch share an SM's 227 KB (each also pays 1 KB of reserve);
    at 512 keys the block still fits."""
    assert 2 * (k1.smem_bytes_bwd_tc(128, 512, 8) + 1024) <= k1.SMEM_LIMIT
    assert k1.smem_bytes_bwd_tc(512, 512, 8) <= k1.SMEM_LIMIT
    # C 2,048 at 16 heads and C 4,096 at 32: the rows launch's 32 rows of C
    # do not fit, so the call takes the composed route (K1's tensor-core
    # forward, the LayerNorm backward, K5 and K6 on the tensor cores); the
    # SIMT kernels these shapes took before still fit, 8 rows a block at 32 keys
    assert k1.smem_bytes_bwd_tc(32, 2048, 16) > k1.SMEM_LIMIT
    assert k1.k2_path(torch.bfloat16, 128, 32, 2048, 16) == "composed"
    for c, heads in ((2048, 16), (4096, 32)):
        bf = torch.zeros(1, 32, c, dtype=torch.bfloat16)
        args = (bf, bf, bf, torch.ones(1, 32), torch.ones(1, 32), torch.ones(1, 32, 32), bf,
                torch.ones(c), torch.zeros(c), heads, "l1")
        k1._check(*args, dy=bf)
        assert k1.k2_path(torch.bfloat16, 128, 32, c, heads) == "composed"
        assert k1.smem_bytes_bwd(32, 32, c, heads) <= k1.SMEM_LIMIT
    assert k1.simt_bwd_rows(32, 32, 4096, 32) == 8


def bwd_inputs(rng, b=2, t=9, c=16):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    res = rng.standard_normal((b, t, c)).astype(np.float32)
    q = np.maximum(res * 0.5 + 0.1, 0).astype(np.float32)
    k = np.maximum(x * 0.3 - 0.05, 0).astype(np.float32)
    v = np.maximum(x, 0).astype(np.float32)
    km = np.ones((b, t), np.float32)
    km[0, -2:] = 0.0
    qm = (rng.random((b, t)) > 0.15).astype(np.float32)
    graph = (rng.random((b, t, t)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, t, c)).astype(np.float32)
    return (q, k, v, km, qm, graph, res, gamma, beta), dy


@pytest.mark.parametrize("renorm", k1.RENORMS)
def test_k2_plain_bf16_rounding_points_against_the_jax_kernel(rng, renorm):
    """K2's plain version rounds dO, dS and the weights A to bf16 before the
    products that take them (the tensor-core kernels multiply bf16
    operands); the JAX kernel keeps the three in f32. Each rounding moves an
    operand by at most 2^-9 of its magnitude, and every output is a sum of
    products of such operands, rounded to bf16 once more: the outputs stay
    within one bf16 ulp (2^-7) of each output's largest magnitude. dgamma
    and dbeta never see the three roundings: 1e-5."""
    args, dy = bwd_inputs(rng)
    t = [torch.from_numpy(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    for i in (0, 1, 2, 6):
        t[i] = t[i].bfloat16()
        j[i] = j[i].astype(jnp.bfloat16)
    got = k1.graph_attention_ln_bwd_plain(*t, torch.from_numpy(dy).bfloat16(), 4, renorm)
    want = fused_attention_bwd(*j, jnp.asarray(dy).astype(jnp.bfloat16), 4, renorm,
                               interpret=True)
    for name, g, w in zip(("dq", "dk", "dv", "dresidual", "dgamma", "dbeta"), got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        if name in ("dgamma", "dbeta"):
            assert g.dtype == torch.float32
            assert float((g - w).abs().max()) <= 1e-5, name
        else:
            assert g.dtype == torch.bfloat16
            close(g.float(), w, name, tol=2.0 ** -7)


def test_k2_plain_rounds_nothing_in_f32(rng):
    """The rounding points are casts to q's dtype: in float32 the plain
    backward is the unrounded formula, bit for bit what autograd's operands
    see (held to autograd at 1e-5 in test_torch_port_attention_bwd)."""
    args, dy = bwd_inputs(rng)
    t = [torch.from_numpy(a) for a in args]
    got = k1.graph_attention_ln_bwd_plain(*t, torch.from_numpy(dy), 4, "l1")
    leaves = [x.clone().requires_grad_(i in (0, 1, 2, 6, 7, 8)) for i, x in enumerate(t)]
    out = k1.graph_attention_ln_plain(*leaves, 4, "l1")
    want = torch.autograd.grad(out, [leaves[i] for i in (0, 1, 2, 6, 7, 8)], torch.from_numpy(dy))
    for name, g, w in zip(("dq", "dk", "dv", "dresidual", "dgamma", "dbeta"), got, want):
        assert g.dtype == torch.float32
        close(g, w, name, tol=1e-5)


@pytest.mark.parametrize("dtype,head_dim,tq,want,warps", [
    (torch.bfloat16, 64, 128, "tensor-core", 4), (torch.bfloat16, 64, 1, "tensor-core", 1),
    (torch.bfloat16, 48, 66, "tensor-core", 4), (torch.bfloat16, 16, 16, "tensor-core", 1),
    (torch.bfloat16, 8, 66, "simt", 4), (torch.bfloat16, 40, 17, "simt", 4),
    (torch.float32, 64, 128, "f32", 4), (torch.bfloat16, 256, 128, "tensor-core", 4),
    (torch.bfloat16, 256, 1, "tensor-core", 1), (torch.bfloat16, 136, 66, "simt", 4),
    (torch.bfloat16, 256, 512, "tensor-core", 8), (torch.bfloat16, 128, 512, "tensor-core", 4),
])
def test_k1_kernel_path(dtype, head_dim, tq, want, warps):
    """K1 takes the tensor-core kernels in bf16 at head widths that are
    multiples of 16 up to 256 and the register-tiled f32 kernel in f32;
    other bf16 widths keep the SIMT kernel. The decoder's one query takes
    blocks of one warp."""
    assert k1.k1_path(dtype, head_dim) == want
    assert k1.tc_warps(tq, head_dim) == warps


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.float32, 4, "f32"), (torch.float32, 8, "f32"), (torch.float32, 36, "f32"),
    (torch.float32, 128, "f32"), (torch.float32, 10, "simt"), (torch.float32, 132, "simt"),
    (torch.float32, 256, "simt"), (torch.bfloat16, 128, "tensor-core"),
    (torch.bfloat16, 12, "simt"), (torch.bfloat16, 144, "tensor-core"),
    (torch.bfloat16, 256, "tensor-core"), (torch.bfloat16, 136, "simt"),
    (torch.bfloat16, 272, "wide"),
])
def test_k1_path_by_head_width(dtype, head_dim, want):
    """f32 takes the register-tiled kernel at head widths that are multiples
    of 4 up to 128 (the tiles' float4 rows and register accumulators) and
    the first SIMT kernel otherwise, e.g. hidden 2,048 over 8 heads (256);
    bf16 takes the tensor-core kernel at multiples of 16 up to K1's own
    limit, 256 (Gemma-2B's heads), above the shared ``kernel_path``'s 128;
    the choice is the shape's."""
    assert k1.k1_path(dtype, head_dim) == want
    if dtype == torch.bfloat16:
        tc = head_dim % 16 == 0 and head_dim <= k1.K14_TC_MAX_HEAD_DIM
        assert (k1.k1_path(dtype, head_dim) == "tensor-core") == tc
        assert k1.K14_TC_MAX_HEAD_DIM == 256 and k1.TC_MAX_HEAD_DIM == 128


@pytest.mark.parametrize("c,heads,tq,tk,rows,blocks_an_sm", [
    (512, 8, 128, 128, 64, 2), (512, 8, 66, 66, 64, 2), (512, 8, 1, 128, 16, 4),
    (256, 4, 128, 128, 64, 2), (512, 8, 99, 192, 64, 2), (512, 8, 300, 300, 48, 2),
    (512, 8, 50, 299, 48, 2), (512, 8, 512, 512, 32, 2), (512, 16, 66, 66, 64, 3),
    (1024, 8, 16, 128, 16, 2), (1024, 8, 128, 512, 32, 1),
])
def test_k1_f32_shared_memory_and_scratch(c, heads, tq, tk, rows, blocks_an_sm):
    """One block of K1's f32 kernel (the Q tile, two stages of a K or V tile
    and the key mask, the score rows of 64 ceil(Tk / 64) + 8 floats) fits
    the 227 KB a block may use; at the model's head width of 64 two blocks
    share an SM at every key count (48 rows a block above 192 keys, 32 above
    320), each
    paying 1 KB of reserve. The attention output goes to an f32 (B, Tq, C)
    scratch."""
    need = k1.smem_bytes_f32(tq, tk, c, heads)
    width = next(w for w in (32, 64, 128) if c // heads <= w)
    ld = -(-tk // 64) * 64 + 8
    assert need == 4 * (rows * width + 2 * (64 * width + 64) + rows * ld)
    assert k1.f32_plan(2, heads, tq, tk)[0] == rows
    assert blocks_an_sm * (need + 1024) <= k1.SMEM_LIMIT < (blocks_an_sm + 1) * (need + 1024)
    q = torch.zeros(2, tq, c)
    o = k1.o_scratch(q, heads)
    assert o.dtype == torch.float32 and tuple(o.shape) == (2, tq, c)
    bf16_path = k1.k1_path(torch.bfloat16, c // heads)
    assert (k1.o_scratch(q.bfloat16(), heads) is None) == (bf16_path == "simt")
    assert k1.o_scratch(torch.zeros(2, tq, 120), 12) is None    # head width 10: SIMT


@pytest.mark.parametrize("tq", [1, 16, 17, 128])
@pytest.mark.parametrize("tk", [1, 64, 192, 193, 320, 321, 512])
def test_k1_f32_leaves_two_blocks_an_sm_at_head_width_64(tq, tk):
    """Whatever the keys (up to 512) and the rows, two blocks of K1's f32
    kernel share an SM at head width 64, which its launch bounds ask for."""
    assert 2 * (k1.smem_bytes_f32(tq, tk, 512, 8) + 1024) <= k1.SMEM_LIMIT


@pytest.mark.parametrize("tq,tk", [(128, 128), (66, 66), (1, 128), (1, 300), (300, 300),
                                   (50, 299), (512, 512)])
@pytest.mark.parametrize("batch", [4, 64, 128])
def test_k1_f32_plan_is_the_same_at_4_and_8_heads(batch, tq, tk):
    """K1's f32 kernel takes no key split and its row tile follows the rows
    and keys alone, so a model rank's 4 heads sum each head's keys as one
    process's 8 heads do."""
    plan = k1.f32_plan(batch, 8, tq, tk)
    assert plan == k1.f32_plan(batch, 4, tq, tk) == k1.f32_plan(batch, 1, tq, tk)
    assert plan == (16 if tq <= 16 else 64 if tk <= 192 else 48 if tk <= 320 else 32, 1,
                    -(-tk // 64))


@pytest.mark.parametrize("head_dim,blocks_an_sm", [
    (16, 3), (32, 3), (48, 2), (64, 2), (96, 1), (128, 1),
])
def test_k6_f32_shared_memory_fits(head_dim, blocks_an_sm):
    """One block of K6's f32 kernel (K and V of 64 keys, the warps'
    transposed tiles, two stages of Q, dO, the graph tile and the rows' m,
    z, b, delta) fits the 227 KB a block may use; its launch bounds ask for
    two blocks an SM up to head width 64, which its shared memory leaves
    (each block paying 1 KB of reserve), and one above."""
    need = flash.smem_bytes_dkv_f32(head_dim)
    assert blocks_an_sm * (need + 1024) <= k1.SMEM_LIMIT < (blocks_an_sm + 1) * (need + 1024)
    assert flash.smem_bytes_dkv_f32(64) == 4 * (2 * 64 * 64 + 4 * 32 * 16
                                                + 2 * (2 * 32 * 64 + 32 * 64 + 4 * 32))
    assert flash.dkv_kernel(torch.float32, head_dim) == "f32"
    assert flash.dkv_kernel(torch.bfloat16, head_dim) == flash.kernel_path(torch.bfloat16,
                                                                           head_dim)


@pytest.mark.parametrize("batch,heads,tq,tk,want", [
    (4, 8, 1536, 1536, (64, 1, 48)),   # the encoder: 768 blocks, no split
    (4, 4, 1536, 1536, (64, 1, 48)),   # a model rank's 4 heads: 384 blocks
    (4, 8, 768, 768, (64, 1, 24)),     # the ring's rotation
    (4, 8, 1, 1536, (16, 12, 4)),      # the decoder's one query: 32 blocks of one warp -> 384
    (4, 4, 1, 1536, (16, 12, 4)),      # ... on 4 heads: the same shards
    (2, 8, 1, 1536, (16, 12, 4)),      # ... on a data-parallel rank's 2 samples
    (4, 8, 70, 1536, (64, 12, 4)),     # two query tiles
    (4, 8, 200, 700, (64, 6, 4)),      # 128 blocks: under the card, a ragged last shard
    (1, 1, 1, 32, (16, 1, 1)),         # one step cannot be split
    (1, 1, 1, 100, (16, 1, 4)),        # four steps: one shard of them all
    (64, 8, 16, 300, (16, 1, 10)),     # 512 blocks of 16 rows
])
def test_dq_f32_plan_is_a_pure_function_of_the_shapes(batch, heads, tq, tk, want):
    """K5's float32 kernel: rows a block, then shards of four 32-key steps
    when the blocks do not cover the card, whatever the head count; the
    wrapper's split is this plan's."""
    assert flash.dq_f32_plan(batch, heads, tq, tk) == want
    assert flash.dq_key_split(torch.float32, 64, batch, heads, tq, tk) == want[1:]


@pytest.mark.parametrize("batch,tq,tk", [
    (4, 1536, 1536), (4, 1, 1536), (4, 768, 768), (4, 200, 700), (4, 70, 1536), (4, 1, 66),
    (2, 1536, 1536), (2, 1, 1536), (1, 1, 1536),
])
def test_dq_f32_plan_is_the_same_at_4_and_8_heads(batch, tq, tk):
    """At the obj+rel point (its encoder, decoder and ring calls; and a
    data-parallel rank's share of the batch) a model rank's 4 heads take one
    process's 8 heads' query tile and shards, so each head's dQ sums its
    keys in the same order."""
    assert flash.dq_f32_plan(batch, 4, tq, tk) == flash.dq_f32_plan(batch, 8, tq, tk)


@pytest.mark.parametrize("tk", [1, 31, 32, 33, 128, 129, 700, 701, 1536, 4096])
@pytest.mark.parametrize("blocks", [(1, 1, 1), (4, 8, 1), (4, 4, 1), (2, 8, 100), (16, 8, 64),
                                    (4, 8, 1536)])
def test_dq_f32_key_split_leaves_no_shard_empty(blocks, tk):
    batch, heads, tq = blocks
    q_tile, n_split, per = flash.dq_f32_plan(batch, heads, tq, tk)
    steps = -(-tk // flash.DQ_F32_STEP)
    assert q_tile == (16 if tq <= 16 else 64)
    assert n_split >= 1 and per >= 1
    assert (n_split - 1) * per < steps <= n_split * per          # the kernel's own guard
    if batch * heads * -(-tq // q_tile) >= flash.SM_COUNT:
        assert n_split == 1
    else:
        assert per == min(flash.F32_SPLIT_STEPS, steps)


@pytest.mark.parametrize("head_dim,q_tile,blocks_an_sm", [
    (64, 64, 2), (48, 64, 2), (32, 64, 4), (16, 64, 4), (128, 64, 1), (96, 64, 1),
    (64, 16, 5), (128, 16, 2),
])
def test_k5_f32_shared_memory_fits(head_dim, q_tile, blocks_an_sm):
    """One block of K5's f32 kernel (Q and dO, two stages of K, V, the
    graph tile and the key mask) fits the 227 KB a block may use; at the
    model's head width of 64 two blocks of 64 rows (8 warps) share an SM,
    each paying 1 KB of reserve, as its launch bounds ask."""
    need = flash.smem_bytes_dq_f32(head_dim, q_tile)
    assert blocks_an_sm * (need + 1024) <= k1.SMEM_LIMIT < (blocks_an_sm + 1) * (need + 1024)
    assert flash.smem_bytes_dq_f32(64, 64) == 4 * (2 * 64 * 64
                                                   + 2 * (2 * 32 * 64 + 64 * 32 + 32))


def test_k5_takes_the_f32_kernel_at_every_f32_width():
    """Every float32 head width the f32 kernel takes (multiples of 4 up to
    256, instance 256 above 128) runs K5's f32 kernel, every other one up
    to 256 the SIMT kernel; bfloat16 takes the tensor-core kernel at every
    multiple of 16 up to 256, the SIMT kernel elsewhere."""
    for head_dim in range(1, flash.SIMT_MAX_HEAD_DIM + 1):
        tiled = head_dim % 4 == 0
        assert flash.dq_kernel(torch.float32, head_dim) == ("f32" if tiled else "simt")
        assert flash.dq_kernel(torch.bfloat16, head_dim) == (
            "tensor-core" if head_dim % 16 == 0 else "simt")


@pytest.mark.parametrize("renorm", flash.RENORMS)
@pytest.mark.parametrize("tq,tk", [(1, 1536), (200, 700), (70, 1536)], ids=str)
def test_k5_f32_shard_sum_equals_the_unsplit_dq_and_jax(rng, tq, tk, renorm):
    """The key ranges K5's float32 kernel cuts at the obj+rel point (B 4, 8
    heads: shards of 128 keys, the last ragged): the plain K5 on each range
    with every row's statistics, summed in shard order, against the plain K5
    over all keys and the JAX package's dQ (its K5 in interpret mode)."""
    _, n_split, per = flash.dq_f32_plan(4, 8, tq, tk)
    keys = per * flash.DQ_F32_STEP
    bounds = [(i * keys, min(tk, (i + 1) * keys)) for i in range(n_split)]
    assert n_split > 1 and bounds[-1][1] == tk
    args = flash_inputs(rng, tq=tq, tk=tk)
    q, k, v, key_mask, query_mask, graph = args
    dy = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32))
    out, m, z, bsum = flash.flash_graph_attention_plain(*args, HEADS, renorm, "stats")
    d_out, delta = flash.masked_grad_and_delta(out, dy, query_mask, HEADS)
    stats = (m, z, bsum, delta, d_out, HEADS, renorm)
    parts = torch.stack([flash.flash_bwd_dq_plain(
        q, *(t[:, lo:hi].contiguous() for t in (k, v, key_mask)),
        graph[:, :, lo:hi].contiguous(), *stats) for lo, hi in bounds])
    got = flash.sum_dq_shards_plain(parts, torch.float32)
    close(got, flash.flash_bwd_dq_plain(q, k, v, key_mask, graph, *stats), "dq", F32_TOL)
    jq, jk, jv, jkm, jqm, jg = (jnp.asarray(t.numpy()) for t in args)
    _, vjp = jax.vjp(lambda q_: jax_flash_graph_attention(q_, jk, jv, jkm, jqm, jg, HEADS, renorm,
                                                          8, 256, True), jq)
    close(got, torch.from_numpy(np.array(vjp(jnp.asarray(dy.numpy()))[0])), "dq against JAX",
          F32_TOL)


def identity_inputs(rng, b, tq, tk, c):
    """K1's attention inputs, float32: sample 0 has every key masked, the
    last sample's row 0 an all-zero graph (no neighbour), some queries are
    padding."""
    xq = rng.standard_normal((b, tq, c)).astype(np.float32)
    xk = rng.standard_normal((b, tk, c)).astype(np.float32)
    q = np.maximum(xq * 0.5 + 0.1, 0).astype(np.float32)
    k = np.maximum(xk * 0.3 - 0.05, 0).astype(np.float32)
    v = np.maximum(xk, 0).astype(np.float32)
    km = (rng.random((b, tk)) > 0.2).astype(np.float32)
    km[0] = 0.0
    qm = (rng.random((b, tq)) > 0.15).astype(np.float32)
    graph = (rng.random((b, tq, tk)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    return q, k, v, km, qm, graph


K1_IDENTITY_TOL = 1e-6   # f32 sums in another order, of each output's largest magnitude
K1_JAX_TOL = 1e-5        # the JAX package's own kernel tests' tolerance


@pytest.mark.parametrize("renorm", k1.RENORMS)
@pytest.mark.parametrize("tq,tk", [(9, 9), (130, 130), (1, 300), (50, 299), (3, 512)])
def test_k1_attention_equals_k4_out_and_jax(rng, monkeypatch, tq, tk, renorm):
    """K1's renorm of softmax x graph and K4's online form of it agree:
    e g / max(b, 1e-12 z) (l1) or e g / (b + 1e-7 z) (sum_eps) with z = sum
    e, b = sum e g (a graph that is not negative). K1's plain attention
    equals K4's plain ``emit="out"`` within 1e-6 at up to 512 keys, both
    renorms, a sample whose keys are all masked and a row with no
    neighbour; at the self-attention shapes both equal the JAX package's
    ``fused_graph_attention`` in interpret mode within 1e-5."""
    import structured_alignment_vqa_tpu.ops.pallas_attention as pa

    heads = 4
    args = identity_inputs(rng, 2, tq, tk, 32)
    t = [torch.from_numpy(a) for a in args]
    got = k1.graph_attention_plain(*t, heads, renorm)
    want = flash.flash_graph_attention_plain(*t, heads, renorm, "out")
    close(got, want, "K1 against K4", K1_IDENTITY_TOL)
    assert float(got[-1, 0].abs().max()) == 0.0                 # no neighbour: 0
    assert float(got[0].abs().max()) > 0.0                     # all keys masked: uniform
    if tq == tk:
        monkeypatch.setattr(pa, "INTERPRET_MODE", True)
        jax_out = pa.fused_graph_attention(*(jnp.asarray(a) for a in args), heads, renorm)
        jax_out = torch.from_numpy(np.array(jax_out))
        close(got, jax_out, "K1 against JAX", K1_JAX_TOL)
        close(want, jax_out, "K4 against JAX", K1_JAX_TOL)


def test_k1_tensor_core_shared_memory_leaves_four_blocks_an_sm():
    """At the model's shapes (C 512, 8 heads, up to 128 keys) four blocks of
    K1's tensor-core kernel (16 warps) share an SM's 227 KB, each paying 1 KB
    of reserve; 512 keys still fit; a head of 129-256 takes the tensor-core
    kernel at multiples of 16 (else the SIMT kernel) and one wider than 256
    the wide path (the wide K4 kernel and the LayerNorm kernel), whose
    shared memory fits."""
    assert 4 * (k1.smem_bytes_tc(128, 128, 512, 8) + 1024) <= k1.SMEM_LIMIT
    assert 4 * (k1.smem_bytes_tc(66, 66, 512, 8) + 1024) <= k1.SMEM_LIMIT
    assert k1.smem_bytes_tc(1, 512, 512, 8) <= k1.SMEM_LIMIT
    assert k1.smem_bytes_tc(128, 128, 512, 8) == 2 * (64 + 256) * 72 + 4 * 2 * 2 * 64
    # a head of 144 is taken by the tensor-core kernel (instance 256), one of
    # 136 (no multiple of 16) by the SIMT kernel, one of 264 by the wide path
    assert k1.k1_path(torch.bfloat16, 144) == "tensor-core"
    for c, want in ((288, "tensor-core"), (272, "simt"), (528, "wide")):
        bf = torch.zeros(1, 4, c, dtype=torch.bfloat16)
        args = (bf, bf, bf, torch.ones(1, 4), torch.ones(1, 4), torch.ones(1, 4, 4), bf,
                torch.ones(c), torch.zeros(c), 2, "l1")
        k1._check(*args)
        assert k1.k1_path(torch.bfloat16, c // 2, 4, c) == want
    assert flash.smem_bytes_wide("K4") <= k1.SMEM_LIMIT


@pytest.mark.parametrize("rows,hidden,want", [
    (16384, 2048, (1, 32)),     # 256 tiles of 64 rows: no split
    (8448, 2048, (1, 32)),      # 132 tiles: one wave
    (6144, 2048, (1, 32)),      # 96 tiles
    (128, 2048, (32, 1)),       # the decoders: 2 tiles -> 64 blocks
    (264, 2048, (16, 2)),       # obj+rel's decoders and visual FFN: 5 tiles -> 80 blocks
    (4, 2048, (32, 1)),         # obj+rel's decoder: 1 tile
    (4224, 2048, (2, 16)),      # 66 tiles: two shards fill the card
    (64, 64, (1, 1)),           # one chunk cannot be split
])
def test_k3_split_is_a_pure_function_of_the_shapes(rows, hidden, want):
    for c in k3.WIDTHS:
        assert k3.ffn_split(rows, c, hidden) == want
        assert k3.ffn_split(rows, c, hidden) == want          # and says so twice
    # float32 takes the products path and its own rule (tests/test_torch_port_ffn_f32.py)
    assert k3.kernel_ffn_split(torch.float32, rows, 512, hidden) == \
        k3.products_plan(rows, 512, hidden, torch.float32)[1:]


@pytest.mark.parametrize("hidden", [64, 192, 512, 2048, 4096])
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 200, 1000, 8447, 8448, 20000])
def test_k3_split_leaves_no_shard_empty(rows, hidden):
    n_split, per = k3.ffn_split(rows, 512, hidden)
    chunks = hidden // k3.HIDDEN_CHUNK
    assert n_split >= 1 and per >= 1
    assert (n_split - 1) * per < chunks <= n_split * per      # the kernel's own guard
    tiles = -(-rows // k3.TC_ROWS)
    assert tiles * n_split <= max(k3.SM_COUNT, tiles)          # never past one wave by splitting
    if tiles >= k3.SM_COUNT // 2 + 1:
        assert n_split == 1


def test_k3_tensor_core_shared_memory_fits_one_block_an_sm():
    """One block of the bf16 kernel (8 warps, 64 rows) fits the 227 KB a
    block may use at every width the kernel is built for."""
    for c in k3.WIDTHS:
        assert k3.smem_bytes_tc(c) <= k3.SMEM_LIMIT
    assert k3.smem_bytes_tc(512) == 218112


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_shard_sum_equals_the_unsplit_call(rng, dtype):
    """The split path: each shard's f32 partial h W2^T over its hidden
    chunks (h rounded to x's dtype, as the kernel rounds it), summed by the
    second kernel's plain version, against the unsplit plain version. f32:
    1e-5 (sums in another order); bf16: one output ulp below 4 (2^-6)."""
    rows, c, hidden = 70, 128, 512
    def draw(shape, scale, dt=dtype):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dt)

    x, b1, b2 = draw((rows, c), 1.0), draw(hidden, 0.1), draw(c, 0.1)
    w1, w2 = draw((hidden, c), c ** -0.5), draw((c, hidden), hidden ** -0.5)
    gamma, beta = 1 + draw(c, 0.1, torch.float32), draw(c, 0.1, torch.float32)
    n_split, per = k3.ffn_split(rows, c, hidden)
    assert n_split > 1
    parts = []
    for sp in range(n_split):
        lo, hi = 64 * per * sp, min(hidden, 64 * per * (sp + 1))
        h = torch.relu(x.float() @ w1[lo:hi].float().T + b1[lo:hi].float()).to(dtype)
        parts.append(h.float() @ w2[:, lo:hi].float().T)
    got = k3.shard_sum_plain(torch.stack(parts), x, b2, gamma, beta)
    want = k3.ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((got.float() - want.float()).abs().max()) <= tol
