"""The plain versions of the port's flash graph-attention kernels (K4, K5,
K6), run on the CPU, against the JAX package: its Pallas kernels in interpret
mode at 8 x 8 tiles (several tiles in both directions), ``jax.grad`` through
them, and its composite ``attention_core``. Then the port's autograd node
against ``torch.autograd`` of the port's ``attention_core``.

Tolerances. float32: 1e-5 of each output's largest magnitude (sums in
another order). bfloat16: one bf16 ulp at each output's largest magnitude
(2^-7 of it: both sides sum in f32 and round once).

The JAX wrapper pads the keys to its tile with masked keys. On a row whose
real keys are all masked, those pads add exp(0) to z; the port takes exactly
Tk keys. So m, z and b are held on rows with a live key, and ``out`` and the
gradients everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.ops import attention as jax_attention
from structured_alignment_vqa_tpu.ops import pallas_flash_attention as jax_flash
from structured_alignment_vqa_tpu_torch.ops import attention
from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
TILES = dict(q_tile=8, k_tile=8, interpret=True)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def make_inputs(rng, b, tq, tk, c, case="random"):
    """q, k, v, key_mask, query_mask, graph as float32 numpy arrays.

    ``random``: two padding keys in sample 0, some padding queries, a
    zero-graph (dead) row. ``masked_tile``: the second half of the keys is
    padding while the graph connects everything (the cross-stage block over
    padding). ``masked_row``: every key of sample 0 is masked.
    """
    x = rng.standard_normal((b, tk, c)).astype(np.float32)
    xq = x if tq == tk else rng.standard_normal((b, tq, c)).astype(np.float32)
    if case == "masked_tile":
        x[0, tk // 2:] = 0.0
    elif case == "masked_row":
        x[0] = 0.0
    else:
        x[0, -2:] = 0.0
    q = np.maximum(xq * 0.5 + 0.1, 0).astype(np.float32)
    k = np.maximum(x * 0.3 - 0.05, 0).astype(np.float32)
    v = np.maximum(x, 0).astype(np.float32) + (0.1 if case != "random" else 0.0)
    km = (np.abs(x.sum(-1)) > 0).astype(np.float32)
    qm = km.copy() if tq == tk else (rng.random((b, tq)) > 0.15).astype(np.float32)
    if case == "masked_tile":
        graph = np.ones((b, tq, tk), np.float32)
    else:
        graph = (rng.random((b, tq, tk)) > 0.4).astype(np.float32)
        graph[-1, 0] = 0.0                            # a dead row: b = 0 < eps * z
        graph[0, min(3, tq - 1)] = 0.0
    return q, k, v, km, qm, graph


def as_torch(arrays, dtype=torch.float32):
    q, k, v, km, qm, graph = (torch.from_numpy(a) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), km, qm, graph


def as_jax(arrays, dtype=jnp.float32):
    q, k, v, km, qm, graph = (jnp.asarray(a) for a in arrays)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype), km, qm, graph


def assert_close(got, want, rtol, name):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert np.isfinite(got).all() and err <= rtol, (name, err)


SHAPES = [(20, 20), (13, 27), (1, 21)]
# (tq, tk, case) held against the JAX kernels (interpret mode is slow)
PALLAS_CASES = [(20, 20, "random"), (20, 20, "masked_tile"), (20, 20, "masked_row"),
                (13, 27, "random"), (1, 21, "masked_tile")]


@pytest.mark.parametrize("tq,tk,case", PALLAS_CASES, ids=lambda s: str(s))
@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
def test_plain_forward_matches_pallas_every_emit(rng, renorm, tq, tk, case):
    arrays = make_inputs(rng, 2, tq, tk, 16, case)
    t, j = as_torch(arrays), as_jax(arrays)
    live = arrays[3].any(axis=1)                      # samples with an unmasked key
    # every emit on the random inputs; "stats" (out and m, z, b) on the masked ones
    for emit in flash.EMITS if case == "random" else ("stats",):
        want = jax_flash._flash_forward(*j, 2, renorm, emit=emit, **TILES)
        got = flash.flash_graph_attention_plain(*t, 2, renorm, emit)
        if emit == "out":
            assert want[1] is None and torch.is_tensor(got)
            assert_close(got, want[0], F32_RTOL, "out")
            continue
        if emit == "partial":
            assert got[0].shape == (2, 2, tq, 8) and got[0].dtype == torch.float32
            assert_close(got[0][live], np.asarray(want[0])[live, :, :tq], F32_RTOL, "a")
        else:
            assert_close(got[0], want[0], F32_RTOL, "out")
        for name, g, w in zip("mzb", got[1:], want[1:]):
            assert g.shape == (2, 2, tq)
            assert_close(g[live], np.asarray(w)[live, :, :tq, 0], F32_RTOL, name)
    composite, _ = jax_attention.attention_core(*j[:5], 2, graph=j[5], renorm=renorm)
    assert_close(flash.flash_graph_attention_plain(*t, 2, renorm), composite, F32_RTOL,
                 "out vs composite")


def test_fully_masked_row_counts_every_key_and_gives_zero():
    """All keys masked: m is the fill value, each key adds exp(0) to z, and
    with a zero V on the padding the l1 output is 0 (a = 0 over eps * z)."""
    b, t, c = 1, 12, 8
    q = torch.rand(b, t, c)
    zeros = torch.zeros(b, t, c)
    out, m, z, bsum = flash.flash_graph_attention_plain(
        q, zeros, zeros, torch.zeros(b, t), torch.ones(b, t), torch.ones(b, t, t), 2, "l1",
        "stats")
    assert torch.all(m == torch.tensor(-2.0 ** 32 + 1)) and torch.all(z == t)
    assert torch.all(bsum == t) and torch.all(out == 0)


@pytest.mark.parametrize("tq,tk,case", PALLAS_CASES, ids=lambda s: str(s))
@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
def test_plain_backward_matches_jax_grad_through_pallas(rng, renorm, tq, tk, case):
    """dq, dk, dv of sum(out * w): the port's plain K5 and K6 on the port's
    plain statistics, against jax.grad through the JAX K5 and K6."""
    arrays = make_inputs(rng, 2, tq, tk, 16, case)
    w = rng.standard_normal((2, tq, 16)).astype(np.float32)
    q, k, v, km, qm, graph = as_jax(arrays)

    def loss(q, k, v):
        return jnp.sum(jax_flash.flash_graph_attention(q, k, v, km, qm, graph, 2, renorm, 8, 8,
                                                       True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    t = as_torch(arrays)
    out, m, z, bsum = flash.flash_graph_attention_plain(*t, 2, renorm, "stats")
    got = flash.flash_graph_attention_bwd_plain(*t, out, m, z, bsum, torch.from_numpy(w), 2,
                                                renorm)
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, wnt, F32_RTOL, name)


@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
def test_bf16_forward_and_backward_round_where_the_kernels_round(rng, renorm):
    """bf16 inputs: out, dq, dk, dv within one bf16 ulp of the JAX kernels',
    so the weights, dO and delta are rounded at the same places."""
    arrays = make_inputs(rng, 2, 20, 20, 16)
    w = rng.standard_normal((2, 20, 16)).astype(np.float32)
    q, k, v, km, qm, graph = as_jax(arrays, jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)

    def run(q, k, v):
        return jax_flash.flash_graph_attention(q, k, v, km, qm, graph, 2, renorm, 8, 8, True)

    want_out, vjp = jax.vjp(run, q, k, v)
    want = vjp(wj)
    t = as_torch(arrays, torch.bfloat16)
    out, m, z, bsum = flash.flash_graph_attention_plain(*t, 2, renorm, "stats")
    assert out.dtype == torch.bfloat16
    assert_close(out, want_out.astype(jnp.float32), BF16_RTOL, "out")
    got = flash.flash_graph_attention_bwd_plain(
        *t, out, m, z, bsum, torch.from_numpy(w).to(torch.bfloat16), 2, renorm)
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert_close(g, wnt.astype(jnp.float32), BF16_RTOL, name)


@pytest.mark.parametrize("case", ["random", "masked_tile", "masked_row"])
@pytest.mark.parametrize("tq,tk", SHAPES, ids=lambda s: str(s))
@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
def test_autograd_node_matches_autograd_of_attention_core(rng, renorm, tq, tk, case):
    """The port's differentiable entry (K4 forward, K5 and K6 backward, here
    their plain versions) against torch.autograd of the eager composite."""
    arrays = make_inputs(rng, 2, tq, tk, 16, case)
    w = torch.from_numpy(rng.standard_normal((2, tq, 16)).astype(np.float32))
    grads = []
    for fn in ("flash", "core"):
        q, k, v, km, qm, graph = as_torch(arrays)
        leaves = [x.requires_grad_() for x in (q, k, v)]
        if fn == "flash":
            out = flash.flash_graph_attention(*leaves, km, qm, graph, 2, renorm)
        else:
            out, _ = attention.attention_core(*leaves, km, qm, 2, graph=graph, renorm=renorm)
        grads.append((out.detach(), *torch.autograd.grad(out, leaves, w)))
    for name, g, wnt in zip(("out", "dq", "dk", "dv"), *grads):
        assert_close(g, wnt.numpy(), F32_RTOL, name)


def test_no_gradient_needed_emits_the_output_alone(rng, monkeypatch):
    arrays = make_inputs(rng, 1, 9, 9, 8)
    emits = []
    real = flash.flash_graph_attention_plain

    def spy(*args):
        emits.append(args[-1])
        return real(*args)

    monkeypatch.setattr(flash, "flash_graph_attention_plain", spy)
    t = as_torch(arrays)
    out = flash.flash_graph_attention(*t, 2, "l1")
    assert emits == ["out"] and not out.requires_grad
    t[0].requires_grad_()
    out = flash.flash_graph_attention(*t, 2, "l1")
    assert emits == ["out", "stats"] and out.requires_grad
    stats = flash.flash_graph_attention(*t, 2, "l1", emit="stats")
    assert len(stats) == 4 and not stats[0].requires_grad
    assert flash.flash_graph_attention.launches == 0   # CPU tensors launch no kernel


def test_wrapper_checks_refuse_what_the_kernels_do_not_take():
    """Heads wider than 256 (264; 257 at C 2,056) are taken: by the wide
    kernels, but K4's in f32 at 264, a multiple of 4, which takes its
    chunked f32 kernel (C was never a limit of K4-K6's kernels); C not
    divisible by the heads and another dtype are refused."""
    q = torch.zeros(1, 4, 12)
    args = (q, q, q, torch.ones(1, 4), torch.ones(1, 4, 4))
    flash._check(*args, 2, "l1", {})                   # head width 6: the SIMT kernels take it
    for c, heads, k4 in ((528, 2, "f32-chunked"), (2056, 8, "wide")):
        wide = torch.zeros(1, 4, c)
        flash._check(wide, wide, wide, *args[3:], heads, "l1", {})
        assert flash.k4_path(torch.float32, c // heads) == k4
        assert flash.dq_kernel(torch.float32, c // heads) == "wide"
    with pytest.raises(ValueError, match="divisible"):
        flash._check(*args, 5, "l1", {})
    half = q.half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash._check(half, half, half, *args[3:], 2, "l1", {})
    with pytest.raises(ValueError, match="renorm"):
        flash._check(*args, 3, "l2", {})
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash._check(q.half(), q.half(), q.half(), *args[3:], 3, "l1", {})
    with pytest.raises(ValueError, match="contiguous"):
        flash._check(q, q, q, args[3], torch.ones(1, 4, 8)[:, :, ::2], 3, "l1", {})
    with pytest.raises(ValueError, match="emit"):
        flash.flash_graph_attention_plain(*args[:4], torch.ones(1, 4), args[4], 3, "l1", "all")


def test_long_keys_go_to_the_flash_path_in_the_attention_module(rng, monkeypatch):
    """Above MAX_KEYS the module calls flash_graph_attention and finishes
    with the eager residual + LayerNorm; the result equals the composite's."""
    from structured_alignment_vqa_tpu_torch.ops.fused_graph_attention import MAX_KEYS

    c, t = 8, MAX_KEYS + 8
    mod = attention.GraphGuidedAttention(c, 2, device="cpu").eval()
    x = torch.from_numpy(rng.standard_normal((1, t, c)).astype(np.float32))
    graph = torch.from_numpy((rng.random((1, t, t)) > 0.5).astype(np.float32))
    calls = []
    real = attention.flash_graph_attention
    monkeypatch.setattr(attention, "flash_graph_attention",
                        lambda *a: calls.append(a[1].shape[1]) or real(*a))
    with torch.no_grad():
        got = mod(x, x, x, graph)
        dec = mod(x[:, :1], x, x, graph[:, :1])       # the decoder's one query
        q, k, v = mod.Q_proj(x), mod.K_proj(x), mod.V_proj(x)
        mask = attention.content_mask(x)
        out, _ = attention.attention_core(q, k, v, mask, mask, 2, graph=graph, renorm="l1")
        want = mod._finish(out, x)
    assert calls == [t, t]
    assert_close(got, want.numpy(), F32_RTOL, "module")
    assert_close(dec, want[:, :1].numpy(), F32_RTOL, "one query")
