"""The port's losses, train step and eval step against the JAX package.

Same weights (JAX params perturbed with numpy noise, carried by
``models/convert.py``) and the same numpy batches on both sides, float32 on
the CPU, dropout 0 wherever the two are compared (the frameworks draw
different masks from a seed). Gradients are compared relative to each
gradient's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.ops.layers import label_smoothing as jax_label_smoothing
from structured_alignment_vqa_tpu.parallel.train_step import TrainState as JaxState
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam
from structured_alignment_vqa_tpu.parallel.train_step import make_eval_step as jax_eval_step
from structured_alignment_vqa_tpu.parallel.train_step import make_train_step as jax_train_step
from structured_alignment_vqa_tpu.train import losses as jax_losses
from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.ops.layers import label_smoothing
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    TrainState,
    adam,
    make_eval_step,
    make_train_step,
)
from structured_alignment_vqa_tpu_torch.train import losses
from test_torch_port_model import TINY, build_pair, jax_batch

LOSS_ATOL = 1e-6     # the losses alone, on the same logits
GRAD_RTOL = 1e-4     # one step's gradients, relative to each gradient's max |.|
STEP_LOSS_ATOL = 1e-4  # 20 steps: each step's loss
# 20 steps at lr 1e-3: the final params. Adam divides each gradient by its
# own scale, so an element whose gradient stays near rounding noise takes
# steps of up to lr in a direction the noise picks (seen: 4e-5).
PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def _logits(rng, b=6, k=11):
    lc, lv, ls = (rng.standard_normal((b, k)).astype(np.float32) * 3 for _ in range(3))
    answer = rng.integers(0, k, size=b)
    answer[:2] = 0                                   # out-of-vocabulary answers
    valid = np.ones(b, np.int32)
    valid[-2:] = 0                                   # invalid samples
    return lc, lv, ls, answer, valid


def test_label_smoothing_matches_jax(rng):
    y = np.eye(7, dtype=np.float32)[rng.integers(0, 7, size=5)]
    for eps in (0.0, 0.1, 0.3):
        np.testing.assert_allclose(label_smoothing(torch.from_numpy(y), eps).numpy(),
                                   np.asarray(jax_label_smoothing(jnp.asarray(y), eps)),
                                   atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("all_invalid", [False, True])
def test_losses_and_metrics_match_jax(rng, all_invalid):
    lc, lv, ls, answer, valid = _logits(rng)
    if all_invalid:
        valid[:] = 0                                 # the mean's denominator floors at 1
    t = [torch.from_numpy(a) for a in (lc, lv, ls, answer, valid)]
    j = [jnp.asarray(a) for a in (lc, lv, ls, answer, valid)]
    loss, log_sm = losses.ensemble_smoothed_ce(*t, smooth_eps=0.1)
    want_loss, want_log_sm = jax_losses.ensemble_smoothed_ce(*j, smooth_eps=0.1)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(log_sm.numpy(), np.asarray(want_log_sm), atol=LOSS_ATOL, rtol=0)
    if all_invalid:
        assert loss.item() == 0.0
    got = losses.batch_metrics(log_sm, t[3], t[4])
    want = jax_losses.batch_metrics(want_log_sm, j[3], j[4])
    assert [x.item() for x in got] == [float(x) for x in want]
    mo, mr = np.float32(0.7), np.float32(-1.3)
    for only_obj in (True, False):
        np.testing.assert_allclose(
            losses.mil_nce_loss(torch.tensor(mo), torch.tensor(mr), only_obj).item(),
            float(jax_losses.mil_nce_loss(jnp.asarray(mo), jnp.asarray(mr), only_obj)),
            atol=LOSS_ATOL, rtol=0)


def test_accuracy_counts_in_vocabulary_answers_over_every_valid_sample():
    log_sm = torch.log_softmax(torch.eye(4) * 5, dim=-1)    # predicts 0, 1, 2, 3
    answer = torch.tensor([0, 1, 2, 0])
    valid = torch.tensor([1, 1, 0, 1])
    n_correct, n = losses.batch_metrics(log_sm, answer, valid)
    assert (n_correct.item(), n.item()) == (1.0, 3.0)


def _jax_loss(jmodel, cfg_only_obj):
    def loss_fn(params, jb):
        lc, lv, ls, mo, mr = jmodel.apply({"params": params}, jb, deterministic=False,
                                          rngs={"dropout": jax.random.key(0)})
        ce, _ = jax_losses.ensemble_smoothed_ce(lc, lv, ls, jb.answer, jb.sample_valid, 0.1)
        return ce + jax_losses.mil_nce_loss(mo, mr, cfg_only_obj)
    return loss_fn


def _assert_grads_match(model, jgrads, num_blocks, rtol):
    want = state_dict_from_jax(jax.device_get(jgrads), num_blocks)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        w = want[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(w.abs().max().item(), 1e-12)
        err = (g - w).abs().max().item() / scale
        assert err <= rtol, (name, err)


@pytest.fixture(scope="module")
def pallas_grads():
    """One batch, the port's initial weights, and the JAX gradient of the
    loss with the JAX model on its Pallas kernels (interpret mode, jitted):
    K1's forward and K2's backward kernel in the encoder self-attentions."""
    # the Pallas path has the composite's parameter tree: init without it
    jmodel, jparams, jb, model, batch = build_pair(TINY, False, False, batch=2)
    pallas_model = type(jmodel)(jmodel.cfg.replace(use_pallas_attention=True))
    pa.INTERPRET_MODE = True
    try:
        jgrads = jax.jit(jax.grad(_jax_loss(pallas_model, True)))(jparams, jb)
    finally:
        pa.INTERPRET_MODE = False
    return {k: v.clone() for k, v in model.state_dict().items()}, batch, jax.device_get(jgrads)


def _stepped_model(weights, batch):
    """A port model with ``weights`` after one train step on ``batch``."""
    model = AttModelX3(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(weights)
    opt = adam(model.parameters())
    make_train_step(model, opt, ModelConfig(**TINY))(TrainState(model, opt), batch)
    return model


def test_one_step_gradients_match_jax_grad_through_its_k2(pallas_grads):
    """The port runs K1's and K2's plain versions in the encoder
    self-attentions and the decoder's cross-attentions."""
    weights, batch, jgrads = pallas_grads
    _assert_grads_match(_stepped_model(weights, batch), jgrads, TINY["num_blocks"], GRAD_RTOL)


def test_marco_mlp_gets_no_gradient_on_either_side(pallas_grads):
    """The macro embeddings are detached in the reference MIL_NCE: JAX gives
    MIL_NCE.marco_mlp a zero gradient, the port none at all."""
    weights, batch, jgrads = pallas_grads
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(jgrads["mil_nce"]["marco_mlp"]))
    model = _stepped_model(weights, batch)
    assert model.MIL_NCE.marco_mlp[0].weight.grad is None
    assert model.MIL_NCE.marco_mlp[0].bias.grad is None
    assert model.MIL_NCE.syb_mlp[0].weight.grad.abs().max() > 0


def _batches(cfg, n, size=3):
    out = []
    for s in range(n):
        arrays = synthetic_arrays(cfg, size, lv=4, lq=5, ls=10, seed=20 + s)
        arrays["answer"][0] = 0
        arrays["sample_valid"][-1] = 0
        out.append(arrays)
    return out


def test_twenty_steps_track_jax_make_train_step():
    """Adam at lr 1e-3 with a 5-step linear warmup, 20 steps over 4 batches
    (each with an answer 0 and an invalid sample); JAX runs its composite
    attention and FFN. Each step's loss and the final params within 1e-4."""
    jmodel, jparams, _, model, _ = build_pair(TINY, True, False)
    cfg = ModelConfig(share_glove=True, **TINY)
    arrays = _batches(cfg, 4)
    tx = jax_adam(1e-3, warmup_steps=5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                      opt_state=tx.init(jparams))
    jstep = jax_train_step(jmodel, tx, jmodel.cfg)
    opt = adam(model.parameters(), lr=1e-3, warmup_steps=5)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    for i in range(20):
        a = arrays[i % len(arrays)]
        jstate, jm = jstep(jstate, jax_batch(a), jax.random.key(1))
        m = step(state, batch_from_arrays(a, "cpu"))
        assert m["skipped"].item() == float(jm["skipped"]) == 0.0
        for key in ("loss", "ce", "mil_nce_loss"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=STEP_LOSS_ATOL,
                                       rtol=0, err_msg=f"step {i} {key}")
        for key in ("n_correct", "n"):
            assert m[key].item() == float(jm[key])
    assert state.step == int(jstate.step) == 20
    assert opt.param_groups[0]["updates"] == 20
    want = state_dict_from_jax(jax.device_get(jstate.params), TINY["num_blocks"])
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_obj_rel_steps_track_jax_make_train_step():
    """only_obj=False: six Adam steps over three batches; the loss carries
    -mil_rel (``mil_nce_loss`` with ``only_obj=False``) and ``MIL_NCE.R``
    trains. Each step's loss, ce and MIL term and the final params within
    1e-4 of the JAX step's."""
    kw = dict(TINY, only_obj=False)
    jmodel, jparams, _, model, _ = build_pair(kw, True, False)
    cfg = ModelConfig(share_glove=True, **kw)
    # seeds whose relation records are not all padding (mil_rel finite)
    arrays = [a for a in _batches(cfg, 6) if (a["micro_pos_rel_loc"][..., 3] >= 0).any()][:3]
    assert len(arrays) == 3
    tx = jax_adam(1e-3)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                      opt_state=tx.init(jparams))
    jstep = jax_train_step(jmodel, tx, jmodel.cfg)
    opt = adam(model.parameters(), lr=1e-3)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    r_before = model.MIL_NCE.R.detach().clone()
    for i in range(6):
        a = arrays[i % len(arrays)]
        jstate, jm = jstep(jstate, jax_batch(a), jax.random.key(1))
        m = step(state, batch_from_arrays(a, "cpu"))
        assert m["skipped"].item() == float(jm["skipped"]) == 0.0
        for key in ("loss", "ce", "mil_nce_loss"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=STEP_LOSS_ATOL,
                                       rtol=0, err_msg=f"step {i} {key}")
    assert not torch.equal(model.MIL_NCE.R, r_before)
    want = state_dict_from_jax(jax.device_get(jstate.params), kw["num_blocks"])
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_warmup_matches_optax_linear_schedule():
    sched = optax.linear_schedule(0.0, 1e-3, 4)
    p = torch.nn.Parameter(torch.ones(2))
    opt = adam([p], lr=1e-3, warmup_steps=4)
    from structured_alignment_vqa_tpu_torch.parallel.train_step import _schedule_lr

    for n in range(7):
        opt.param_groups[0]["updates"] = n
        _schedule_lr(opt)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(n)), rtol=1e-6)


def test_poisoned_batch_is_skipped_and_changes_nothing():
    _, _, _, model, batch = build_pair(TINY, True, False)
    cfg = ModelConfig(share_glove=True, **TINY)
    opt = adam(model.parameters(), lr=1e-3)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    assert step(state, batch)["skipped"].item() == 0.0
    params = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()} for i, s in opt.state_dict()["state"].items()}
    vis = batch.vis_fea.clone()
    vis[0, 0, 0] = float("nan")
    m = step(state, dataclasses.replace(batch, vis_fea=vis))
    assert m["skipped"].item() == 1.0 and not np.isfinite(m["loss"].item())
    assert state.step == 2 and opt.param_groups[0]["updates"] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, moments[i][k]), (i, k)
    assert step(state, batch)["skipped"].item() == 0.0   # the next finite batch applies


def test_eval_step_sums_match_jax():
    jmodel, jparams, _, model, _ = build_pair(TINY, False, False)
    arrays = _batches(ModelConfig(**TINY), 1, size=5)[0]
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=None)
    want = jax_eval_step(jmodel, jmodel.cfg)(jstate, jax_batch(arrays))
    opt = adam(model.parameters())
    got = make_eval_step(model, ModelConfig(**TINY))(TrainState(model, opt),
                                                      batch_from_arrays(arrays, "cpu"))
    assert not model.training
    for key in ("loss_sum", "mil_sum", "n_correct", "n"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), atol=STEP_LOSS_ATOL,
                                   rtol=0, err_msg=key)
    assert got["n"].item() == 4.0


def test_dropout_follows_the_generator_and_eval_ignores_it():
    _, _, _, model, batch = build_pair(dict(TINY, dropout_rate=0.3), True, False)
    cfg = ModelConfig(share_glove=True, **dict(TINY, dropout_rate=0.3))

    def train_loss(seed):
        model.train()
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            lc, lv, ls, mo, mr = model(batch, gen)
        ce, _ = losses.ensemble_smoothed_ce(lc, lv, ls, batch.answer, batch.sample_valid)
        return (ce + losses.mil_nce_loss(mo, mr, cfg.only_obj)).item()

    assert train_loss(3) == train_loss(3)
    assert train_loss(3) != train_loss(4)
    model.eval()
    with torch.no_grad():
        a = model(batch, torch.Generator().manual_seed(3))[0]
        b = model(batch, torch.Generator().manual_seed(4))[0]
        c = model(batch)[0]
    assert torch.equal(a, b) and torch.equal(a, c)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    with torch.no_grad():
        model(batch, gen)
    assert torch.equal(gen.get_state(), state)       # eval mode draws no mask
