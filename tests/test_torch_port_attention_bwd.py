"""K2's plain version (the backward of the port's graph-attention kernel,
run on the CPU) against the JAX package's hand-derived backward kernel
(``pallas_attention_bwd.fused_attention_bwd``, Pallas interpret mode) and
against torch.autograd of K1's plain version.

float32, atol 1e-5 (the tolerance of the JAX package's kernel tests), on
inputs with masked keys, padded queries, an all-zero graph row and a
constant LayerNorm row. The constant row's dresidual is of order 1/eps =
1e8 (the LayerNorm's eps sits on the std, which is 0 there), so each row is
held to 1e-5 of its own largest magnitude where that exceeds 1. Every batch
element keeps at least one live key: with none, the JAX wrapper's padded
keys change the softmax sum (ROADMAP Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.ops.pallas_attention_bwd import fused_attention_bwd
from structured_alignment_vqa_tpu_torch.ops import fused_graph_attention as k1

ATOL = 1e-5
NAMES = ("dq", "dk", "dv", "dresidual", "dgamma", "dbeta")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def make_inputs(rng, b, tq, tk, c):
    """K1's arguments and dy, numpy float32. Row 1 of element 0 is a
    padded query over a constant residual (a constant LayerNorm row: var 0);
    row 0 of the last element has an all-zero graph, as the encoder's
    stage-1 graph on its modality rows."""
    x = rng.standard_normal((b, tk, c)).astype(np.float32)
    x[0, -2:] = 0.0                                   # padding keys
    res = rng.standard_normal((b, tq, c)).astype(np.float32)
    q = np.maximum(res * 0.5 + 0.1, 0).astype(np.float32)
    k = np.maximum(x * 0.3 - 0.05, 0).astype(np.float32)
    v = np.maximum(x, 0).astype(np.float32)
    km = (np.abs(x.sum(-1)) > 0).astype(np.float32)
    qm = (rng.random((b, tq)) > 0.15).astype(np.float32)
    graph = (rng.random((b, tq, tk)) > 0.4).astype(np.float32)
    graph[-1, 0] = 0.0
    if tq > 1:
        qm[0, 1] = 0.0
        res[0, 1] = 0.5                               # exact mean: var is 0
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, tq, c)).astype(np.float32)
    return (q, k, v, km, qm, graph, res, gamma, beta), dy


def plain_bwd(args, dy, heads, renorm, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 2, 6):                            # q, k, v, residual in the working type
        t[i] = t[i].to(dtype)
    return k1.graph_attention_ln_bwd_plain(*t, torch.from_numpy(dy).to(dtype), heads, renorm)


def jax_bwd(args, dy, heads, renorm, dtype=jnp.float32):
    j = [jnp.asarray(a) for a in args]
    for i in (0, 1, 2, 6):
        j[i] = j[i].astype(dtype)
    return fused_attention_bwd(*j, jnp.asarray(dy).astype(dtype), heads, renorm, interpret=True)


def assert_close(got, want, name, tol=ATOL):
    """|got - want| <= tol times the row's largest |want|, floored at 1."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    bad = np.abs(got - want) > tol * scale
    assert not bad.any(), (name, np.abs(got - want).max(), int(bad.sum()))


def test_inputs_hold_the_cases_the_backward_must_get_right(rng):
    (q, k, v, km, qm, graph, res, *_), _ = make_inputs(rng, 2, 9, 9, 16)
    assert (km.sum(-1) >= 1).all() and (km == 0).any()
    assert not graph[-1, 0].any()
    assert qm[0, 1] == 0 and np.ptp(res[0, 1]) == 0


@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
@pytest.mark.parametrize("length,width,heads", [(9, 16, 4), (66, 32, 8)])
def test_plain_backward_matches_jax_kernel(rng, renorm, length, width, heads):
    args, dy = make_inputs(rng, 2, length, length, width)
    got = plain_bwd(args, dy, heads, renorm)
    want = jax_bwd(args, dy, heads, renorm)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        assert_close(g.numpy(), w, name)


@pytest.mark.parametrize("renorm", ["l1", "sum_eps"])
@pytest.mark.parametrize("tq,tk,heads", [(9, 9, 4), (1, 66, 8), (20, 70, 2)],
                         ids=["self", "one-query-cross", "rectangular"])
def test_plain_backward_matches_autograd_of_the_forward(rng, renorm, tq, tk, heads):
    """Tq != Tk, which the JAX kernel does not take, against autograd."""
    args, dy = make_inputs(rng, 3, tq, tk, 16)
    got = plain_bwd(args, dy, heads, renorm)
    leaves = [torch.from_numpy(a).requires_grad_(i in (0, 1, 2, 6, 7, 8))
              for i, a in enumerate(args)]
    out = k1.graph_attention_ln_plain(*leaves, heads, renorm)
    want = torch.autograd.grad(out, [leaves[i] for i in (0, 1, 2, 6, 7, 8)],
                               torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert_close(g.numpy(), w.numpy(), name)


def test_plain_backward_in_bf16_rounds_where_the_kernel_does(rng):
    """bf16 q, k, v, residual and dy. The recomputed forward rounds the
    attention weights to bf16 before @V, as K1 and the JAX kernel do; the
    f32 outputs dgamma and dbeta see that rounding through the LayerNorm
    input, so they match the JAX kernel at 1e-5 only if the plain version
    rounds at the same place. A version that skips it (the same inputs in
    f32) is off by more. The bf16 outputs agree within one bf16 ulp (2^-7)
    of each row's largest magnitude."""
    args, dy = make_inputs(rng, 2, 9, 9, 16)
    got = plain_bwd(args, dy, 4, "l1", torch.bfloat16)
    want = jax_bwd(args, dy, 4, "l1", jnp.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w.astype(jnp.float32))
        if name in ("dgamma", "dbeta"):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)
        else:
            assert g.dtype == torch.bfloat16
            assert_close(g.float().numpy(), w, name, tol=2 ** -7)
    # the same values held in f32 do not round the weights: dgamma moves
    exact = [a.copy() for a in args]
    for i in (0, 1, 2, 6):
        exact[i] = torch.from_numpy(args[i]).bfloat16().float().numpy()
    unrounded = plain_bwd(exact, torch.from_numpy(dy).bfloat16().float().numpy(), 4, "l1")
    assert np.abs(unrounded[4].numpy() - got[4].numpy()).max() > 10 * ATOL


def test_backward_of_the_wrapper_is_the_plain_backward_on_cpu(rng):
    """Autograd through fused_graph_attention_ln on CPU tensors runs
    graph_attention_ln_bwd_plain (no launch is counted): the masks and the
    graph get no gradient."""
    args, dy = make_inputs(rng, 2, 9, 9, 16)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = k1.fused_graph_attention_ln_bwd.launches
    out = k1.fused_graph_attention_ln(*leaves, 4, "l1")
    out.backward(torch.from_numpy(dy))
    assert k1.fused_graph_attention_ln_bwd.launches == before
    want = plain_bwd(args, dy, 4, "l1")
    for i, w in zip((0, 1, 2, 6, 7, 8), want):
        torch.testing.assert_close(leaves[i].grad, w, atol=0, rtol=0)
    assert all(leaves[i].grad is None for i in (3, 4, 5))


def test_backward_wrapper_checks_dy():
    q = torch.zeros(1, 3, 16)
    with pytest.raises(ValueError, match="dy"):
        k1._check(q, q, q, torch.ones(1, 3), torch.ones(1, 3), torch.ones(1, 3, 3), q,
                  torch.ones(16), torch.zeros(16), 2, "l1", dy=torch.zeros(1, 3, 8))
    # a head wider than the SIMT kernels' 256 is taken, by the wide path
    wide = torch.zeros(1, 3, 2 * (k1.SIMT_MAX_HEAD_DIM + 1))
    c = wide.shape[-1]
    k1._check(wide, wide, wide, torch.ones(1, 3), torch.ones(1, 3), torch.ones(1, 3, 3),
              wide, torch.ones(c), torch.zeros(c), 1, "l1", dy=wide)
    assert k1.k2_path(torch.float32, c, 3, c, 1) == "wide"
