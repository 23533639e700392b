"""The port's ablation variants of the max-pool and dec families
(``models/variants.py``) against the JAX package's, and the attention
features they need (``ops/attention.py``: attention weights out, attention
dropout, a broadcast graph).

Each variant gets the same random weights (carried by
``models/convert_variants.py``, loaded ``strict=True``) and the same numpy
inputs (``tests/variant_port_cases.py``); float32 on the CPU, where the
port's attention and FFN run their kernels' plain versions. Logits agree
within 1e-4, attention weights within 1e-5, gradients within 1e-4 of each
one's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import variant_port_cases as vc
from structured_alignment_vqa_tpu.models import variants as jax_variants
from structured_alignment_vqa_tpu_torch.models import AttModelX3, tiny_test_config
from structured_alignment_vqa_tpu_torch.models import variants as port_variants
from structured_alignment_vqa_tpu_torch.ops import attention as port_attention
from structured_alignment_vqa_tpu_torch.ops.attention import (
    GraphGuidedAttention,
    GraphMaskAttention,
    attention_core,
)

NAMES = vc.MAX_POOL + vc.DEC + ("x2_dec_ori", "x4_dec")
DEEP = dict(num_blocks=6, stage1_blocks=2, stage2_blocks=4)   # the reference's depth


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False


def _port_out(name, params, kw=None):
    model = vc.port_model(name, params)
    with torch.no_grad():
        return model(*vc.port_args(vc.numpy_inputs(name)), **(kw or {}))


@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax(name):
    """Every output, converted weights loaded strictly, no JAX leaf unread.
    An alias (a byte-identical fork) reuses its twin's JAX result and must
    build the same port class with the same arguments."""
    twin = vc.ALIASES.get(name, name)
    assert port_variants.VARIANTS[name] == port_variants.VARIANTS[twin]
    assert jax_variants.VARIANTS[name][1] == port_variants.VARIANTS[name][1]
    params, want = vc.jax_case(twin)
    assert not vc.unmapped_leaves(name, params)
    vc.assert_outputs_close(_port_out(name, params), want, name)


@pytest.mark.parametrize("name,cfg_kw", [
    ("x2", DEEP),                                  # symbolic blocks 4 and 5 never built
    ("x2_fusion_dec", dict(DEEP, share_glove=True)),
    ("x2_dec_ori", DEEP),
    ("x4_dec", DEEP),
], ids=["MaxPoolDualEncoder", "X2DecModel", "X2DecOriModel", "X4DecModel"])
def test_name_map_covers_both_models(name, cfg_kw):
    """At the reference's depth: the map names every port parameter and
    every JAX leaf, shape for shape."""
    vc.name_map_matches(name, **cfg_kw)


def test_x2_dec_vis_graph_option():
    """The visual block's adjacency from the input changes the output, on
    both sides alike."""
    rng = np.random.default_rng(9)
    vis_graph = (rng.random((vc.B, vc.LV, vc.LV)) > 0.6).astype(np.float32)
    cfg, _ = vc.configs("x2_dec")
    jmodel = jax_variants.build_variant("x2_dec", cfg)
    params, base = vc.jax_case("x2_dec")
    want = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)},
                        *vc.jax_args(vc.numpy_inputs("x2_dec")),
                        vis_graph=jnp.asarray(vis_graph))
    got = _port_out("x2_dec", params, {"vis_graph": torch.from_numpy(vis_graph)})
    vc.assert_outputs_close(got, want, "x2_dec vis_graph")
    assert not np.allclose(np.asarray(base), got.numpy(), atol=1e-3)


def test_x2_dec_gradients_match_jax_grad():
    """The eval's label-smoothed CE through x2_dec (l1 graph attention):
    every gradient against jax.grad's."""
    name = "x2_dec"
    cfg, _ = vc.configs(name)
    params, _ = vc.jax_case(name)
    answer = np.array([3, 7])
    args = vc.numpy_inputs(name)
    jmodel = jax_variants.build_variant(name, cfg)
    jgrads = jax.jit(jax.grad(lambda p: vc.smoothed_ce(
        jmodel.apply({"params": p}, *vc.jax_args(args)), answer, jnp)))(
        jax.tree.map(jnp.asarray, params))
    model = vc.port_model(name, params)
    vc.smoothed_ce(model(*vc.port_args(args)), answer, torch).backward()
    vc.assert_grads_match(name, model, jax.device_get(jgrads))


def test_build_variant_x3_gives_the_production_model():
    for name in ("x3", "v3"):
        assert type(port_variants.build_variant(name, tiny_test_config(), device="cpu")) \
            is AttModelX3
    assert set(port_variants.VARIANTS) == set(jax_variants.VARIANTS)


# ---- the attention features the variants add -------------------------------------


def _qkv(b=2, tq=5, tk=7, c=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, c, generator=g) for t in (tq, tk, tk)]


def _dropout_module(rate=0.5):
    torch.manual_seed(0)
    return GraphGuidedAttention(8, 2, device="cpu", dropout_rate=rate, return_att=True)


def test_attention_dropout_leaves_the_returned_weights_alone():
    """The weights come back post-renorm and pre-dropout, in train mode as
    in eval mode, while the output moves."""
    mod = _dropout_module()
    q, k, v = _qkv()
    graph = (torch.rand(2, 5, 1, generator=torch.Generator().manual_seed(1)) > 0.3).float()
    out_eval, att_eval = mod.eval()(q, k, v, graph)
    out_train, att_train = mod.train()(q, k, v, graph, torch.Generator().manual_seed(3))
    torch.testing.assert_close(att_train, att_eval, rtol=0, atol=0)
    assert not torch.allclose(out_train, out_eval)


def test_attention_dropout_draws_nothing_in_eval_and_one_mask_per_seed():
    mod = _dropout_module()
    q, k, v = _qkv()
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    mod.eval()(q, k, v, torch.ones(2, 5, 7), gen)
    assert torch.equal(gen.get_state(), state)
    mod.train()
    a = mod(q, k, v, torch.ones(2, 5, 7), torch.Generator().manual_seed(3))[0]
    b = mod(q, k, v, torch.ones(2, 5, 7), torch.Generator().manual_seed(3))[0]
    c = mod(q, k, v, torch.ones(2, 5, 7), torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_attention_dropout_keep_rate_and_scale():
    """With V the identity, the output is the dropped weights: each entry
    0 or weight / (1 - p), about 1 - p of them kept."""
    p, b, tq, tk = 0.3, 4, 64, 32
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(b, tq, tk, generator=g), torch.randn(b, tk, tk, generator=g)
    v = torch.eye(tk).expand(b, tk, tk)
    ones = torch.ones(b, tq)
    out, att = attention_core(q, k, v, torch.ones(b, tk), ones, 1, graph=torch.ones(b, tq, tk),
                              renorm="l1", dropout_rate=p,
                              generator=torch.Generator().manual_seed(5))
    att = att[:, 0]
    kept = out != 0
    torch.testing.assert_close(out[kept], att[kept] / (1 - p), rtol=1e-6, atol=0)
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02


@pytest.mark.parametrize("tk", [7, 520], ids=["K1 plain", "K4 plain"])
def test_broadcast_graph_reaches_the_kernel_path_expanded(tk):
    """A (B, Tq, 1) query-validity graph: the module without weights out
    (the kernels' path, their plain versions here; K4 above 512 keys)
    equals attention_core broadcasting the same graph."""
    torch.manual_seed(0)
    mod = GraphGuidedAttention(8, 2, device="cpu").eval()
    q, k, v = _qkv(tk=tk)
    graph = torch.tensor([[1.0, 1, 0, 1, 0], [0, 1, 1, 1, 1]])[..., None]
    got = mod(q, k, v, graph)
    pq, pk, pv = mod.Q_proj(q), mod.K_proj(k), mod.V_proj(v)
    out, _ = attention_core(pq, pk, pv, port_attention.content_mask(k),
                            port_attention.content_mask(q), 2, graph=graph, renorm="l1")
    want = mod._finish(out, q)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_mask_only_attention_takes_a_ones_graph():
    """GraphMaskAttention without a graph: a ones graph through the kernel
    path equals attention_core with no graph (softmax, then sum + 1e-7)."""
    torch.manual_seed(0)
    mod = GraphMaskAttention(8, 2, device="cpu").eval()
    q, k, v = _qkv()
    got = mod(q, k, v)
    out, _ = attention_core(mod.Q_proj(q), mod.K_proj(k), mod.V_proj(v),
                            port_attention.content_mask(k), port_attention.content_mask(q), 2,
                            renorm="sum_eps")
    torch.testing.assert_close(got, mod._finish(out, q), rtol=1e-5, atol=1e-5)
