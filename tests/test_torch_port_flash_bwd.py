"""What surrounds K5 and K6 (the flash graph-attention backward) and runs on
the CPU: the rounding points their plain versions share with the
tensor-core kernels, the rule that picks a kernel and K5's key split, the
sum of K5's key shards and the guard on its scratch.

Rounding. For bf16 inputs the kernels multiply dS and n as bf16 operands
(dQ = dS K, dK = dS^T Q, dV = n^T dO); the JAX kernels keep both in f32.
Each rounding moves an operand by at most 2^-9 of its magnitude and every
output is a sum of such products rounded to bf16 once more, so the plain
versions stay within one bf16 ulp (2^-7) of each output's largest
magnitude of the JAX kernels'. In f32 nothing is rounded: bit for bit the
unrounded formulas. The shard sum: float32, 1e-6 of the largest magnitude
(sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.ops import pallas_flash_attention as jax_flash
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

HEADS = 2
BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def make_inputs(rng, case, b=2, tq=20, tk=20, c=16):
    """q, k, v, key_mask, query_mask, graph as float32 numpy arrays.
    ``dead_row``: padding keys in sample 0, row 0 of the last sample with an
    all-zero graph (b = 0 < eps z). ``masked_tile``: keys 8-15 of sample 0
    (the second 8-key tile of the JAX kernels) masked. ``masked_row``: every
    key of sample 0 masked (m is the fill value, each key counts e = 1)."""
    x = rng.standard_normal((b, tk, c)).astype(np.float32)
    xq = x if tq == tk else rng.standard_normal((b, tq, c)).astype(np.float32)
    q = np.maximum(xq * 0.5 + 0.1, 0).astype(np.float32)
    k = np.maximum(x * 0.3 - 0.05, 0).astype(np.float32)
    v = np.maximum(x, 0).astype(np.float32) + 0.1
    km = np.ones((b, tk), np.float32)
    if case == "dead_row":
        km[0, -2:] = 0.0
    elif case == "masked_tile":
        km[0, 8:16] = 0.0
    else:
        km[0] = 0.0
    qm = km.copy() if tq == tk else (rng.random((b, tq)) > 0.15).astype(np.float32)
    graph = (rng.random((b, tq, tk)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    return q, k, v, km, qm, graph


def close(got, want, name, rtol):
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max()) / scale
    assert bool(torch.isfinite(got).all()) and err <= rtol, (name, err)


def plain_backward(arrays, dy, renorm, dtype):
    """The port's plain forward statistics, then its plain K5 and K6."""
    q, k, v, km, qm, graph = (torch.from_numpy(a) for a in arrays)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out, m, z, bsum = flash.flash_graph_attention_plain(q, k, v, km, qm, graph, HEADS, renorm,
                                                        "stats")
    d_out, delta = flash.masked_grad_and_delta(out, torch.from_numpy(dy).to(dtype), qm, HEADS)
    return (q, k, v, km, graph, m, z, bsum, delta, d_out, HEADS, renorm)


@pytest.mark.parametrize("case", ["dead_row", "masked_tile", "masked_row"])
@pytest.mark.parametrize("renorm", flash.RENORMS)
def test_bf16_plain_k5_k6_round_ds_and_n_within_an_ulp_of_jax(rng, renorm, case):
    """The plain K5 and K6 (dS and n rounded to bf16) against the VJP of the
    JAX flash attention, whose backward runs the JAX K5 (_bwd_dq_kernel) and
    K6 (_bwd_dkv_kernel) in interpret mode at 8 x 8 tiles."""
    arrays = make_inputs(rng, case)
    dy = rng.standard_normal((2, 20, 16)).astype(np.float32)
    q, k, v, km, qm, graph = (jnp.asarray(a) for a in arrays)
    q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))

    def run(q, k, v):
        return jax_flash.flash_graph_attention(q, k, v, km, qm, graph, HEADS, renorm, 8, 8, True)

    _, vjp = jax.vjp(run, q, k, v)
    want = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    bwd = plain_backward(arrays, dy, renorm, torch.bfloat16)
    got = (flash.flash_bwd_dq_plain(*bwd), *flash.flash_bwd_dkv_plain(*bwd))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        close(g, np.array(w.astype(jnp.float32)), name, BF16_RTOL)


@pytest.mark.parametrize("renorm", flash.RENORMS)
def test_f32_plain_k5_k6_round_nothing(rng, renorm):
    """In float32 the rounding points are casts to float32: the plain K5 and
    K6 are bit for bit the products of the unrounded dS and n."""
    bwd = plain_backward(make_inputs(rng, "dead_row"), rng.standard_normal((2, 20, 16))
                         .astype(np.float32), renorm, torch.float32)
    q, k, v, d_out = bwd[0], bwd[1], bwd[2], bwd[9]
    ds, n = flash._ds_and_n(*bwd)
    heads = lambda x: flash._heads(x, HEADS)   # noqa: E731
    dq = flash._merge(torch.matmul(ds, heads(k)))
    dk = flash._merge(torch.matmul(ds.transpose(-1, -2), heads(q)))
    dv = flash._merge(torch.matmul(n.transpose(-1, -2), heads(d_out)))
    got = (flash.flash_bwd_dq_plain(*bwd), *flash.flash_bwd_dkv_plain(*bwd))
    for name, g, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert g.dtype == torch.float32 and torch.equal(g, w), name
    assert not torch.equal(ds, ds.bfloat16().float())   # bf16 would have rounded something


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "tensor-core"), (torch.bfloat16, 16, "tensor-core"),
    (torch.bfloat16, 48, "tensor-core"), (torch.bfloat16, 128, "tensor-core"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 40, "simt"), (torch.float32, 64, "simt"),
])
def test_k5_k6_kernel_path(dtype, head_dim, want):
    """f32 runs on the CUDA cores (TF32 would break 1e-4), in K5's and K6's
    register-tiled f32 kernels; a bf16 head width that is no multiple of 16
    keeps the first SIMT kernels."""
    assert flash.kernel_path(dtype, head_dim) == want
    f32 = "f32" if dtype == torch.float32 else want
    assert flash.dq_kernel(dtype, head_dim) == flash.dkv_kernel(dtype, head_dim) == f32


@pytest.mark.parametrize("dtype,head_dim,tq,tk,want", [
    (torch.bfloat16, 64, 1, 1536, (8, 3)),       # the decoder's one query: 32 blocks -> 256
    (torch.bfloat16, 64, 1536, 1536, (1, 24)),   # the encoder: 768 blocks, no split
    (torch.bfloat16, 64, 200, 700, (3, 4)),
    (torch.bfloat16, 8, 1, 1536, (1, 24)),       # SIMT: never split
    (torch.float32, 64, 1, 1536, (6, 4)),        # K4's f32 kernel: shards of 4 steps
])
def test_k4_k5_key_split_on_the_tensor_cores_only(dtype, head_dim, tq, tk, want):
    """K4's split (``kernel_key_split``); K5's (``dq_key_split``): K4's on
    the tensor cores, none on the bf16 SIMT kernel, and on its f32 kernel
    shards of four 32-key steps (``dq_f32_plan``: 12 for the one query)."""
    assert flash.kernel_key_split(dtype, head_dim, 4, 8, tq, tk) == want
    steps = -(-tk // flash.KEY_STEP)
    want_k5 = {"simt": (1, steps), "tensor-core": want,
               "f32": flash.dq_f32_plan(4, 8, tq, tk)[1:]}[flash.dq_kernel(dtype, head_dim)]
    assert flash.dq_key_split(dtype, head_dim, 4, 8, tq, tk) == want_k5
    if dtype == torch.float32:
        assert want_k5 == (12, 4)


@pytest.mark.parametrize("bounds", [((0, 24), (24, 40)), ((0, 8), (8, 16), (16, 40)),
                                    ((0, 8), (8, 16), (16, 24), (24, 32), (32, 40))],
                         ids=lambda b: f"{len(b)}shards")
def test_sum_of_dq_shards_equals_the_unsplit_dq(rng, bounds):
    """K5's partial dQ over key ranges (the plain K5 on a slice of the keys
    with every row's statistics), summed in shard order, against the plain
    K5 over all keys; shard 2 of 3 and of 5 is fully masked in sample 0."""
    arrays = make_inputs(rng, "masked_tile", tq=7, tk=40)
    bwd = plain_backward(arrays, rng.standard_normal((2, 7, 16)).astype(np.float32), "l1",
                         torch.float32)
    q, k, v, km, graph = bwd[:5]
    parts = torch.stack([flash.flash_bwd_dq_plain(
        q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(), km[:, lo:hi].contiguous(),
        graph[:, :, lo:hi].contiguous(), *bwd[5:]) for lo, hi in bounds])
    want = flash.flash_bwd_dq_plain(*bwd)
    got = flash.sum_dq_shards_plain(parts, torch.float32)
    close(got, want, "dq", 1e-6)
    # in shard order, then rounded once: the bf16 result is the f32 sum's rounding
    assert torch.equal(flash.sum_dq_shards_plain(parts, torch.bfloat16), got.bfloat16())
    assert torch.equal(flash.sum_dq_shards_plain(parts[:1], torch.float32), parts[0])


def test_dq_scratch_guard_accepts_what_the_wrapper_allocates():
    q = torch.zeros(4, 1, 512, dtype=torch.bfloat16)
    n_split, per = flash.dq_key_split(q.dtype, 64, 4, 8, 1, 1536)
    flash._check_dq_scratch(torch.empty(n_split, 4, 1, 512), n_split, per, q, 1536)
    flash._check_dq_scratch(None, 1, 24, q, 1536)


def test_dq_scratch_guard_counts_the_f32_kernels_steps():
    """K5's f32 plan counts 32-key steps: its 12 shards of 4 steps cover
    1,536 keys, and the same shards counted in 64-key steps would leave
    some empty."""
    q = torch.zeros(4, 1, 512)
    n_split, per = flash.dq_key_split(q.dtype, 64, 4, 8, 1, 1536)
    assert (n_split, per) == (12, 4)
    flash._check_dq_scratch(torch.empty(n_split, 4, 1, 512), n_split, per, q, 1536,
                            flash.DQ_F32_STEP)
    with pytest.raises(ValueError, match="do not cover"):
        flash._check_dq_scratch(torch.empty(n_split, 4, 1, 512), n_split, per, q, 1536)


@pytest.mark.parametrize("scratch,n_split,per,match", [
    (None, 8, 3, "scratch"),                                     # split without scratch
    (torch.empty(8, 4, 1, 256), 8, 3, "scratch"),                # wrong width
    (torch.empty(7, 4, 1, 512), 8, 3, "scratch"),                # too few shards
    (torch.empty(8, 4, 1, 512, dtype=torch.bfloat16), 8, 3, "scratch"),   # not f32
    (torch.empty(4, 8, 1, 512).transpose(0, 1), 8, 3, "scratch"),         # not contiguous
    (torch.empty(1, 4, 1, 512), 1, 24, "no scratch"),            # one shard takes none
    (torch.empty(8, 4, 1, 512), 8, 2, "do not cover"),           # 16 of 24 steps
    (torch.empty(9, 4, 1, 512), 9, 3, "do not cover"),           # an empty shard
])
def test_dq_scratch_guard_refuses_what_the_kernel_cannot_take(scratch, n_split, per, match):
    q = torch.zeros(4, 1, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        flash._check_dq_scratch(scratch, n_split, per, q, 1536)


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing(rng):
    bwd = plain_backward(make_inputs(rng, "dead_row"), rng.standard_normal((2, 20, 16))
                         .astype(np.float32), "sum_eps", torch.bfloat16)
    before = flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches
    assert torch.equal(flash.flash_bwd_dq(*bwd), flash.flash_bwd_dq_plain(*bwd))
    for g, w in zip(flash.flash_bwd_dkv(*bwd), flash.flash_bwd_dkv_plain(*bwd)):
        assert torch.equal(g, w)
    assert (flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches) == before
