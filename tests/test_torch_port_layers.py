"""The port's primitives against the JAX package's, float32, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.ops import attention as jax_attention
from structured_alignment_vqa_tpu.ops import layers as jax_layers
from structured_alignment_vqa_tpu_torch.ops import attention, layers
from structured_alignment_vqa_tpu_torch.ops.mil_nce import masked_logsumexp, mil_nce_obj_objective

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def test_layer_norm_matches_jax_including_constant_row(rng):
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 1] = 0.0          # padding row
    x[2, 3] = 1.25         # constant non-zero row: std 0, output beta
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(16)).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[2, 3].numpy(), beta, atol=ATOL, rtol=0)


def test_layer_norm_constant_row_has_finite_grad():
    x = torch.full((2, 8), 0.5, requires_grad=True)
    layers.layer_norm(x, torch.ones(8), torch.zeros(8)).sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("zeros_pad,scale", [(True, True), (False, False), (True, False)])
def test_embedding_matches_jax(rng, zeros_pad, scale):
    table = rng.standard_normal((10, 8)).astype(np.float32)
    ids = rng.integers(0, 10, size=(3, 6))
    ids[0, :2] = 0
    jmod = jax_layers.Embedding(10, 8, zeros_pad=zeros_pad, scale=scale)
    want = jmod.apply({"params": {"lookup_table": jnp.asarray(table)}}, jnp.asarray(ids))
    emb = layers.Embedding(10, 8, zeros_pad=zeros_pad, scale=scale, device="cpu")
    emb.load_state_dict({"lookup_table": torch.from_numpy(table)})
    got = emb(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_content_mask_matches_jax(rng):
    x = rng.standard_normal((4, 7, 16)).astype(np.float32)
    x[1, 2:] = 0.0
    x[3, 0] = np.array([1.0, -1.0] * 8, np.float32)   # sums to exactly 0: masked
    want = jax_attention.content_mask(jnp.asarray(x))
    got = attention.content_mask(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3, 0] == 0 and got[1, 3] == 0 and got[0, 0] == 1


@pytest.mark.parametrize("shape", [(2, 9, 16), (3, 1, 16)], ids=["seq", "one-token"])
def test_feed_forward_matches_jax(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    p = {
        "fc1": {"kernel": rng.standard_normal((c, 4 * c)).astype(np.float32) * 0.3,
                "bias": rng.standard_normal(4 * c).astype(np.float32) * 0.1},
        "fc2": {"kernel": rng.standard_normal((4 * c, c)).astype(np.float32) * 0.2,
                "bias": rng.standard_normal(c).astype(np.float32) * 0.1},
        "ln": {"gamma": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
               "beta": (0.1 * rng.standard_normal(c)).astype(np.float32)},
    }
    jmod = jax_layers.FeedForward(c, (4 * c, c))
    want = jmod.apply({"params": p}, jnp.asarray(x))
    ffn = layers.FeedForward(c, (4 * c, c), device="cpu")
    ffn.load_state_dict({
        "conv1.0.weight": torch.from_numpy(p["fc1"]["kernel"].T.copy()),
        "conv1.0.bias": torch.from_numpy(p["fc1"]["bias"]),
        "conv2.weight": torch.from_numpy(p["fc2"]["kernel"].T.copy()),
        "conv2.bias": torch.from_numpy(p["fc2"]["bias"]),
        "normalization.gamma": torch.from_numpy(p["ln"]["gamma"]),
        "normalization.beta": torch.from_numpy(p["ln"]["beta"]),
    })
    with torch.no_grad():
        got = ffn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_mil_nce_obj_objective_matches_jax(rng):
    from structured_alignment_vqa_tpu.ops import mil_nce as jax_mil

    pos = rng.standard_normal((3, 4, 2)).astype(np.float32)
    neg = rng.standard_normal((3, 4, 2)).astype(np.float32)
    pos[0, 3] = 0.0
    want = jax_mil.mil_nce_obj_objective(jnp.asarray(pos), jnp.asarray(neg))
    got = mil_nce_obj_objective(torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("axis", [None, 1])
def test_masked_logsumexp_matches_jax(rng, axis):
    from structured_alignment_vqa_tpu.ops import mil_nce as jax_mil

    x = rng.standard_normal((3, 5)).astype(np.float32)
    valid = rng.random((3, 5)) > 0.3
    valid[:, 0] = True
    want = jax_mil.masked_logsumexp(jnp.asarray(x), jnp.asarray(valid), axis=axis)
    got = masked_logsumexp(torch.from_numpy(x), torch.from_numpy(valid), dim=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_feed_forward_grad_matches_jax(rng):
    """The FFN's backward (autograd of K3's plain composite, the TPU
    package's VJP of its composite) against jax.grad, input and params."""
    import jax

    c = 16
    x = rng.standard_normal((2, 9, c)).astype(np.float32)
    dy = rng.standard_normal((2, 9, c)).astype(np.float32)
    p = {
        "fc1": {"kernel": rng.standard_normal((c, 4 * c)).astype(np.float32) * 0.3,
                "bias": rng.standard_normal(4 * c).astype(np.float32) * 0.1},
        "fc2": {"kernel": rng.standard_normal((4 * c, c)).astype(np.float32) * 0.2,
                "bias": rng.standard_normal(c).astype(np.float32) * 0.1},
        "ln": {"gamma": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
               "beta": (0.1 * rng.standard_normal(c)).astype(np.float32)},
    }
    jmod = jax_layers.FeedForward(c, (4 * c, c))
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(jmod.apply({"params": p_}, x_) * dy),
                      argnums=(0, 1))(p, jnp.asarray(x))
    ffn = layers.FeedForward(c, (4 * c, c), device="cpu")
    ffn.load_state_dict({
        "conv1.0.weight": torch.from_numpy(p["fc1"]["kernel"].T.copy()),
        "conv1.0.bias": torch.from_numpy(p["fc1"]["bias"]),
        "conv2.weight": torch.from_numpy(p["fc2"]["kernel"].T.copy()),
        "conv2.bias": torch.from_numpy(p["fc2"]["bias"]),
        "normalization.gamma": torch.from_numpy(p["ln"]["gamma"]),
        "normalization.beta": torch.from_numpy(p["ln"]["beta"]),
    })
    xt = torch.from_numpy(x).requires_grad_(True)
    (ffn(xt) * torch.from_numpy(dy)).sum().backward()
    pairs = [(xt.grad, gx), (ffn.conv1[0].weight.grad.T, gp["fc1"]["kernel"]),
             (ffn.conv1[0].bias.grad, gp["fc1"]["bias"]),
             (ffn.conv2.weight.grad.T, gp["fc2"]["kernel"]), (ffn.conv2.bias.grad, gp["fc2"]["bias"]),
             (ffn.normalization.gamma.grad, gp["ln"]["gamma"]),
             (ffn.normalization.beta.grad, gp["ln"]["beta"])]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_scales_kept_entries_as_flax_does(rng, dtype):
    """Kept entries become x / (1 - p) in x's dtype, the rest 0: flax
    nn.Dropout's ``where(mask, x / keep, 0)`` on the same mask."""
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32) + 3.0).to(dtype)
    out = layers.dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.6 < kept.float().mean().item() < 0.8
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    want = jnp.where(jnp.asarray(kept.numpy()), xj / 0.7, 0).astype(jnp.float32)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want))
    again = layers.dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_dropout_draws_nothing_in_eval_or_at_rate_zero():
    x = torch.randn(4, 8)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    assert layers.dropout(x, 0.5, False, gen) is x
    assert layers.dropout(x, 0.0, True, gen) is x
    drop = layers.Dropout(0.5).eval()
    assert drop(x, gen) is x
    assert torch.equal(gen.get_state(), state)
