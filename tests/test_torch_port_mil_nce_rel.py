"""The port's obj+rel path against the JAX package: the relation MIL-NCE
math, the whole ``MILNCEModule`` with ``only_obj=False``, and the whole model
and one training step at a bucket long enough (ls + lq > 512) that the
port's symbolic encoder takes its flash path (K4-K6, here their plain
versions).

The JAX attention module calls its flash kernel without ``interpret``, so on
the CPU its composite (``use_pallas_attention=False``) is its reference.
float32 on the CPU, the same weights (perturbed with numpy noise, carried by
``models/convert.py``) and the same numpy batch on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.models import att_model_x3 as jax_x3
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.ops import mil_nce as jax_mil
from structured_alignment_vqa_tpu.train import losses as jax_losses
from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models import att_model_x3 as port_x3
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.ops import attention, mil_nce
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam, make_train_step
from test_torch_port_model import TINY, jax_batch, perturbed

SCALAR_ATOL = 1e-6    # the objectives, on the same scores
MACRO_ATOL = 1e-5     # the rewritten macro features
LOGIT_ATOL = 1e-4     # whole-model logits and mil_rel
GRAD_RTOL = 1e-4      # one step's gradients, relative to each gradient's max |.|

LONG = dict(TINY, only_obj=False, maxlen=600)
LONG_BUCKET = (4, 8, 520)          # lv, lq, ls: the symbolic encoder runs at L 528


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _rel_scores(rng, m=12):
    pos = rng.standard_normal(m).astype(np.float32) * 2
    neg = rng.standard_normal(m).astype(np.float32) * 2
    pos_valid = rng.random(m) > 0.4
    neg_valid = rng.random(m) > 0.4
    pos_valid[0] = True
    return pos, pos_valid, neg, neg_valid


def test_mil_nce_rel_objective_matches_jax(rng):
    pos, pv, neg, nv = _rel_scores(rng)
    want = jax_mil.mil_nce_rel_objective(*map(jnp.asarray, (pos, pv, neg, nv)))
    got = mil_nce.mil_nce_rel_objective(*map(torch.from_numpy, (pos, pv, neg, nv)))
    np.testing.assert_allclose(got.item(), float(want), atol=SCALAR_ATOL, rtol=0)


def test_mil_nce_rel_objective_without_a_valid_relation_is_nan_on_both_sides(rng):
    pos, pv, neg, nv = _rel_scores(rng)
    pv[:] = False
    nv[:] = False
    want = jax_mil.mil_nce_rel_objective(*map(jnp.asarray, (pos, pv, neg, nv)))
    got = mil_nce.mil_nce_rel_objective(*map(torch.from_numpy, (pos, pv, neg, nv)))
    assert np.isnan(float(want)) and np.isnan(got.item())


def test_masked_logsumexp_matches_jax(rng):
    x = rng.standard_normal((3, 5)).astype(np.float32)
    valid = rng.random((3, 5)) > 0.3
    valid[:, 0] = True
    for axis in (None, 1):
        want = jax_mil.masked_logsumexp(jnp.asarray(x), jnp.asarray(valid), axis=axis)
        got = mil_nce.masked_logsumexp(torch.from_numpy(x), torch.from_numpy(valid), dim=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCALAR_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["in_range", "out_of_range", "none_valid"])
def test_compact_softmax_gather_matches_jax(rng, case):
    m = 12
    scores = rng.standard_normal(m).astype(np.float32) * 2
    valid = rng.random(m) > 0.4
    valid[1] = True
    idx = rng.integers(0, max(int(valid.sum()), 1), size=m)
    if case == "out_of_range":        # beyond the compacted vector, beyond M, negative
        idx[:4] = [int(valid.sum()), m, m + 3, -1]
    if case == "none_valid":
        valid[:] = False
    want = jax_mil.compact_softmax_gather(*map(jnp.asarray, (scores, valid, idx)))
    got = mil_nce.compact_softmax_gather(*map(torch.from_numpy, (scores, valid, idx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCALAR_ATOL, rtol=0)
    if case == "in_range":
        assert got.sum() > 0


def rel_arrays(cfg, batch, bucket, seed):
    """A synthetic batch whose relation records hold the awkward cases: sample
    0 has two records on one macro row (and that row is also an object's),
    sample 1 has no relation at all, and sample 0's macro nodes fill the
    whole bucket."""
    lv, lq, ls = bucket
    arrays = synthetic_arrays(cfg, batch, lv=lv, lq=lq, ls=ls, n_rel=6, seed=seed)
    rng = np.random.default_rng(seed + 100)
    arrays["macro_ipt"][0] = rng.integers(1, cfg.vocab_size - 4, size=ls)
    arrays["macro_mask"][0] = 1
    arrays["macro_graph"][0] = (rng.random((ls, ls)) < 0.3).astype(np.int32)
    n_obj = max(int((arrays["macro_obj_loc"][0] >= 0).sum()), 1)
    for j, (macro_loc, micro_loc) in enumerate([(2, 0), (2, 1), (5, 2), (ls - 1, 0)]):
        arrays["micro_pos_rel"][0, j] = rng.integers(1, cfg.vocab_size - 4)
        arrays["micro_pos_rel_loc"][0, j] = [rng.integers(0, n_obj), rng.integers(0, n_obj),
                                             rng.integers(0, cfg.num_relations), macro_loc,
                                             micro_loc]
        arrays["micro_neg_rel_loc"][0, j] = [rng.integers(0, n_obj), rng.integers(0, n_obj),
                                             rng.integers(0, cfg.num_relations), macro_loc,
                                             micro_loc]
    arrays["micro_pos_rel_loc"][0, 4:] = -1
    arrays["micro_neg_rel_loc"][0, 4:] = -1
    arrays["micro_pos_rel_loc"][1] = -1
    arrays["micro_neg_rel_loc"][1] = -1
    return arrays


def build_rel_pair(kw, bucket, batch=2, seed=7, share_glove=True):
    jcfg = JaxConfig(share_glove=share_glove, use_pallas_attention=False, **kw)
    pcfg = ModelConfig(share_glove=share_glove, **kw)
    arrays = rel_arrays(pcfg, batch, bucket, seed)
    jb = jax_batch(arrays)
    jmodel = jax_x3.AttModelX3(jcfg)
    # the parameters do not depend on the bucket: initialise on a short one
    small = jax_batch(synthetic_arrays(pcfg, 2, lv=4, lq=5, ls=10, seed=seed))
    params, jparams = perturbed(jax.jit(jmodel.init)(jax.random.key(0), small)["params"])
    model = AttModelX3(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, pcfg.num_blocks), strict=True)
    return jmodel, jparams, jb, model.eval(), batch_from_arrays(arrays, "cpu"), pcfg


@pytest.fixture(scope="module")
def long_pair():
    return build_rel_pair(LONG, LONG_BUCKET)


def test_mil_module_with_relations_matches_jax():
    """The module alone, with its own GloVe table: duplicate macro rows, a
    relation on an object's row, a sample with no relation."""
    kw = dict(TINY, only_obj=False)
    pcfg = ModelConfig(**kw)
    arrays = rel_arrays(pcfg, 3, (4, 5, 10), seed=7)
    jb, batch = jax_batch(arrays), batch_from_arrays(arrays, "cpu")
    mil = jax_x3.MILNCEModule(JaxConfig(**kw))
    jargs = (jb.vis_fea, jb.macro_ipt, jb.macro_obj_loc, jb.micro_pos_obj, jb.micro_neg_obj,
             jb.micro_obj_mask, jb.micro_pos_rel, jb.micro_neg_rel, jb.micro_pos_rel_loc,
             jb.micro_neg_rel_loc)
    params, jparams = perturbed(jax.jit(mil.init)(jax.random.key(0), *jargs)["params"])
    module = port_x3.MILNCEModule(pcfg, device="cpu")
    weights = state_dict_from_jax({"mil_nce": params}, pcfg.num_blocks)
    module.load_state_dict({k.removeprefix("MIL_NCE."): v for k, v in weights.items()},
                           strict=True)
    want_macro, want_obj, want_rel = jax.jit(mil.apply)({"params": jparams}, *jargs)
    with torch.no_grad():
        got_macro, got_obj, got_rel = module(
            batch.vis_fea, batch.macro_ipt, batch.macro_obj_loc, batch.micro_pos_obj,
            batch.micro_neg_obj, batch.micro_obj_mask, batch.micro_pos_rel,
            batch.micro_pos_rel_loc, batch.micro_neg_rel_loc)
    np.testing.assert_allclose(got_macro.numpy(), np.asarray(want_macro), atol=MACRO_ATOL, rtol=0)
    np.testing.assert_allclose(got_obj.item(), float(want_obj), atol=SCALAR_ATOL, rtol=0)
    np.testing.assert_allclose(got_rel.item(), float(want_rel), atol=MACRO_ATOL, rtol=0)
    assert got_rel.item() != 0.0
    assert tuple(module.R.shape) == (kw["num_relations"], 8, 8)
    assert module.R.dtype == torch.float32


def test_long_forward_takes_the_flash_path_and_matches_jax(long_pair, monkeypatch):
    jmodel, jparams, jb, model, batch, _ = long_pair
    keys = []
    real = attention.flash_graph_attention
    monkeypatch.setattr(attention, "flash_graph_attention",
                        lambda *a: keys.append((a[0].shape[1], a[1].shape[1])) or real(*a))
    want = jax.jit(jmodel.apply)({"params": jparams}, jb)
    with torch.no_grad():
        got = model(batch)
    # the symbolic branch: 3 self-attentions at L 528, 3 one-query cross-attentions
    assert sorted(keys) == [(1, 528)] * 3 + [(528, 528)] * 3
    names = ("logits_concat", "logits_vis", "logits_syb", "mil_obj", "mil_rel")
    for name, w, g in zip(names, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL, rtol=0, err_msg=name)
    assert np.isfinite(got[4].item()) and got[4].item() != 0.0


def _jax_loss(jmodel):
    def loss_fn(params, jb):
        lc, lv, ls, mo, mr = jmodel.apply({"params": params}, jb)
        ce, _ = jax_losses.ensemble_smoothed_ce(lc, lv, ls, jb.answer, jb.sample_valid, 0.1)
        return ce + jax_losses.mil_nce_loss(mo, mr, False)
    return loss_fn


def _one_step_grads(pcfg, weights, batch):
    model = AttModelX3(pcfg, device="cpu")
    model.load_state_dict(weights)
    opt = adam(model.parameters())
    metrics = make_train_step(model, opt, pcfg)(TrainState(model, opt), batch)
    return metrics, {n: p.grad for n, p in model.named_parameters()}


def test_long_step_gradients_match_jax_grad_and_remat_changes_nothing(long_pair):
    """One training step through the plain K4, K5 and K6: the loss (with
    -mil_rel in it) and every gradient, MIL_NCE.R's included, against
    jax.grad of the JAX model's composite; then the same step with
    ``remat_blocks``, which must give the same bits."""
    jmodel, jparams, jb, model, batch, pcfg = long_pair
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jmodel)))(jparams, jb)
    metrics, grads = _one_step_grads(pcfg, weights, batch)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), atol=LOGIT_ATOL, rtol=0)
    assert metrics["skipped"].item() == 0.0
    want = state_dict_from_jax(jax.device_get(jgrads), pcfg.num_blocks)
    # the shared GloVe table is one parameter in the port, three slots in the map
    assert set(grads) <= set(want) and "MIL_NCE.R" in grads
    for name, g in grads.items():
        w = want[name]
        g = torch.zeros_like(w) if g is None else g
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
        assert err <= GRAD_RTOL, (name, err)
    assert grads["MIL_NCE.R"].abs().max() > 0

    remat_metrics, remat_grads = _one_step_grads(pcfg.replace(remat_blocks=True), weights, batch)
    assert torch.equal(remat_metrics["loss"], metrics["loss"])
    for name, g in grads.items():
        assert (g is None) == (remat_grads[name] is None), name
        assert g is None or torch.equal(g, remat_grads[name]), name


def test_remat_recomputes_each_encoder_block_in_the_backward(long_pair, monkeypatch):
    _, _, _, model, batch, pcfg = long_pair
    remat = AttModelX3(pcfg.replace(remat_blocks=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    calls = []
    real = port_x3._Branch._enc_block
    monkeypatch.setattr(port_x3._Branch, "_enc_block",
                        lambda self, i, fea, g: calls.append(i) or real(self, i, fea, g))
    remat.train()
    out = remat(batch)
    n_forward = len(calls)
    assert n_forward == 2 * pcfg.num_blocks            # two branches
    out[0].sum().backward()
    assert len(calls) == 2 * n_forward                 # every block ran once more
    with torch.no_grad():                              # nothing to recompute for: no checkpoint
        remat(batch)
    assert len(calls) == 3 * n_forward


def test_batch_without_any_relation_has_nan_mil_rel_and_zero_gradient_of_it(rng):
    """No valid relation in the whole batch: both logsumexps are -inf and
    mil_rel is NaN on both sides, while its gradient is zero on both sides
    (the invalid slots are selected away). So the step's guard, which reads
    the gradients, does not skip: the logged loss is NaN and the update
    comes from the other terms, in the JAX package and in the port alike."""
    pos, pv, neg, nv = _rel_scores(rng)
    pv[:] = False
    nv[:] = False
    jgrads = jax.grad(lambda p, n: jax_mil.mil_nce_rel_objective(p, jnp.asarray(pv), n,
                                                                 jnp.asarray(nv)),
                      argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(neg))
    assert all(not np.asarray(g).any() for g in jgrads)

    kw = dict(TINY, only_obj=False)
    pcfg = ModelConfig(share_glove=True, **kw)
    arrays = rel_arrays(pcfg, 2, (4, 5, 10), seed=3)
    arrays["micro_pos_rel_loc"][:] = -1
    arrays["micro_neg_rel_loc"][:] = -1
    model = AttModelX3(pcfg, device="cpu")
    opt = adam(model.parameters())
    m = make_train_step(model, opt, pcfg)(TrainState(model, opt), batch_from_arrays(arrays, "cpu"))
    assert np.isnan(m["mil_nce_loss"].item()) and np.isnan(m["loss"].item())
    assert np.isfinite(m["ce"].item()) and m["skipped"].item() == 0.0
    assert not model.MIL_NCE.R.grad.any()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
