"""K3's backward against the JAX package's: ``jax.vjp`` of
``pallas_ffn._composite``, which the JAX ``fused_ffn`` pairs with its Pallas
forward.

The port's backward is autograd of ``fused_ffn.ffn_ln_composite``, whose
products and residual run in x's dtype as ``_composite``'s do. In bf16 both
sides round the hidden activation, y and y + x to bf16 and sum each
product in f32, in other orders: every gradient is held within 2^-6 of its
largest magnitude (two bf16 ulps there, as K2's bf16 checks allow).

Run as a script, it prints the largest difference of each bf16 gradient
from the reference for this backward and for the one before it (autograd
of ``ffn_ln_plain``, which recomputes in f32):

    PYTHONPATH=. python tests/test_torch_port_ffn_bwd.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.ops.pallas_ffn import _composite
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as port_ffn

BF16_TOL = 2.0 ** -6     # of each gradient's largest magnitude
NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")
SHAPES = [(2, 9, 16), (2, 5, 128)]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def make_inputs(rng, b, l, c):
    """x, the weights in the JAX layout (C, Hd) and (Hd, C), biases, LN
    params (off the knife edge) and a cotangent, float32 numpy."""
    hd = 4 * c
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hd)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hd)).astype(np.float32)
    w2 = (rng.standard_normal((hd, c)) / np.sqrt(hd)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, l, c)).astype(np.float32)
    return (x, w1, b1, w2, b2, gamma, beta), dy


def jax_grads(args, dy, dtype):
    """``jax.vjp(_composite, ...)`` with x, the weights, the biases and dy
    in ``dtype`` and gamma, beta float32; each gradient as float32 numpy in
    the port's layout (dw1 (Hd, C), dw2 (C, Hd))."""
    x, w1, b1, w2, b2, gamma, beta = args
    cast = [jnp.asarray(a).astype(dtype) for a in (x, w1, b1, w2, b2)]
    _, vjp = jax.vjp(_composite, *cast, jnp.asarray(gamma), jnp.asarray(beta))
    grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy).astype(dtype))]
    grads[1], grads[3] = grads[1].T, grads[3].T
    return grads


def port_grads(args, dy, dtype, forward):
    """Gradients of ``forward`` (the port's ``fused_ffn``, or any function
    of its arguments) with x, the weights and the biases in ``dtype``."""
    x, w1, b1, w2, b2, gamma, beta = args
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    leaves += [torch.from_numpy(a).requires_grad_() for a in (gamma, beta)]
    out = forward(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dy).to(dtype))
    return grads


def max_rel_diffs(got, want):
    """max |got - want| over max |want|, gradient by gradient."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        out[name] = float(np.abs(g.float().numpy() - w).max() / max(np.abs(w).max(), 1e-30))
    return out


def f32_recompute(x, w1, b1, w2, b2, gamma, beta):
    """The backward K3 had before: autograd of the f32 plain version."""
    return port_ffn.ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_gradients_match_the_jax_composite_vjp(rng, shape):
    args, dy = make_inputs(rng, *shape)
    want = jax_grads(args, dy, jnp.bfloat16)
    got = port_grads(args, dy, torch.bfloat16, port_ffn.fused_ffn)
    for name, g in zip(NAMES, got):
        assert g.dtype == (torch.float32 if name in ("dgamma", "dbeta") else torch.bfloat16), name
        assert bool(torch.isfinite(g.float()).all()), name
    for name, err in max_rel_diffs(got, want).items():
        assert err <= BF16_TOL, (name, err)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_gradients_match_the_jax_composite_vjp(rng, shape):
    args, dy = make_inputs(rng, *shape)
    want = jax_grads(args, dy, jnp.float32)
    got = port_grads(args, dy, torch.float32, port_ffn.fused_ffn)
    for name, err in max_rel_diffs(got, want).items():
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composite_forward(rng, dtype):
    """In float32 the composite is the plain version operation for
    operation: bitwise equal. In bf16 it differs from the plain version only
    where it rounds h W2 + b2 and y + x to bf16: within one bf16 ulp at the
    output's magnitude (2^-6 below 4), and it equals the JAX composite to
    the same bound."""
    args, _ = make_inputs(rng, 2, 9, 16)
    x, w1, b1, w2, b2, gamma, beta = args
    t = [torch.from_numpy(a).to(dtype) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    t += [torch.from_numpy(gamma), torch.from_numpy(beta)]
    comp = port_ffn.ffn_ln_composite(*t)
    plain = port_ffn.ffn_ln_plain(*t)
    assert comp.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(comp, plain)
    else:
        assert float((comp.float() - plain.float()).abs().max()) <= 2.0 ** -6
        cast = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w1, b1, w2, b2)]
        want = np.asarray(_composite(*cast, jnp.asarray(gamma), jnp.asarray(beta)), np.float32)
        assert float(np.abs(comp.float().numpy() - want).max()) <= 2.0 ** -6


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for shape in SHAPES:
        args, dy = make_inputs(np.random.default_rng(0), *shape)
        want = jax_grads(args, dy, jnp.bfloat16)
        for what, fn in (("autograd of ffn_ln_composite (bf16 products)", port_ffn.fused_ffn),
                         ("autograd of ffn_ln_plain (f32 recompute)", f32_recompute)):
            diffs = max_rel_diffs(port_grads(args, dy, torch.bfloat16, fn), want)
            print(f"(B, L, C) = {shape}, {what}: max|port - jax.vjp|/max|jax.vjp| "
                  + ", ".join(f"{n} {e:.3g}" for n, e in diffs.items()))
