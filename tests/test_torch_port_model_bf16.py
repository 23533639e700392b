"""The port's AttModelX3 in bfloat16 against the JAX package in bfloat16.

The tiny config of ``test_torch_port_model.py`` with ``compute_dtype``
bf16 on both sides (params float32, cast at use), the same perturbed
weights and the same numpy batch; JAX runs its default composite path. One
jitted ``jax.value_and_grad`` gives JAX's outputs and gradients; the port
runs its eval forward, its predict step and one ``make_train_step`` step.

Tolerances, chosen for bf16:
- logits within 2^-5: two bf16 ulps at |logit| < 4 (both sides round every
  layer's output to bf16, in other places);
- the answers equal;
- the loss within 2^-7 of its value (one bf16 ulp);
- the gradients, all parameters' joined, within 0.25 of their joint norm.
  The bf16 rounding alone moves them by a few percent, but a ReLU input
  within bf16 rounding of 0 can fall on the other side on the two paths,
  which moves one sample's term in every gradient upstream of it (seen
  here: the concat head's hidden unit at -0.0026 in the port, the other
  side of 0 in JAX, moves ``cls.0``'s gradient by 0.185 of its norm). The
  f32 step is held to 1e-4 of each gradient (test_torch_port_train_step);
  a product in the wrong dtype or a misrouted gradient moves the joint norm
  by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from structured_alignment_vqa_tpu.train import losses as jax_losses
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam, make_train_step
from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step
from test_torch_port_model import TINY, build_pair

LOGIT_ATOL = 2.0 ** -5
LOSS_RTOL = 2.0 ** -7
GRAD_NORM_RTOL = 0.25


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def make_pair():
    """JAX's bf16 outputs, loss and gradients (in the port's names) and the
    port's bf16 model with the same weights, and the batch."""
    jmodel, jparams, jb, model, batch = build_pair(TINY, False, False)
    jbf = type(jmodel)(jmodel.cfg.replace(compute_dtype=jnp.bfloat16))

    def loss_fn(params):
        outs = jbf.apply({"params": params}, jb)
        ce, _ = jax_losses.ensemble_smoothed_ce(*outs[:3], jb.answer, jb.sample_valid, 0.1)
        return ce + jax_losses.mil_nce_loss(outs[3], outs[4], True), outs

    (loss, outs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    cfg = ModelConfig(**TINY, compute_dtype=torch.bfloat16)
    port = AttModelX3(cfg, device="cpu")
    port.load_state_dict(model.state_dict())
    want_grads = state_dict_from_jax(jax.device_get(grads), TINY["num_blocks"])
    return dict(cfg=cfg, model=port, batch=batch, loss=float(loss),
                outs=[np.asarray(o, np.float32) for o in outs[:4]], grads=want_grads)


def test_bf16_logits_and_answers_match_jax(pair):
    model, batch = pair["model"], pair["batch"]
    with torch.no_grad():
        got = model.eval()(batch)
    assert got[0].dtype == torch.bfloat16
    for name, g, w in zip(("logits_concat", "logits_vis", "logits_syb", "mil_obj"), got,
                          pair["outs"]):
        np.testing.assert_allclose(g.float().numpy(), w, atol=LOGIT_ATOL, rtol=0, err_msg=name)
    log_sm = sum(F.log_softmax(torch.from_numpy(w), dim=-1) for w in pair["outs"][:3])
    np.testing.assert_array_equal(make_predict_step(model)(batch).numpy(),
                                  torch.argmax(log_sm, dim=-1).numpy())


def step_errors(pair) -> tuple:
    """One port step: (skipped, loss's relative difference from JAX's, the
    gradients' joint norm-relative difference, all gradients finite, the
    per-parameter norm-relative differences)."""
    model, cfg = pair["model"], pair["cfg"]
    opt = adam(model.parameters())
    metrics = make_train_step(model, opt, cfg)(TrainState(model, opt), pair["batch"])
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(pair["grads"])
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in named.items()}
    got = torch.cat([g.flatten() for g in grads.values()])
    want = torch.cat([pair["grads"][n].flatten() for n in named])
    per = {n: float((g - pair["grads"][n]).norm() / max(float(pair["grads"][n].norm()), 1e-30))
           for n, g in grads.items()}
    loss_err = abs(metrics["loss"].item() - pair["loss"]) / abs(pair["loss"])
    return (metrics["skipped"].item(), loss_err, float((got - want).norm() / want.norm()),
            bool(torch.isfinite(got).all()), per)


def test_bf16_step_loss_and_gradients_match_jax(pair):
    skipped, loss_err, grad_err, finite, _ = step_errors(pair)
    assert skipped == 0.0 and finite
    assert loss_err <= LOSS_RTOL, loss_err
    assert grad_err <= GRAD_NORM_RTOL, grad_err


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_port_model_bf16.py: the numbers the tests hold
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    p = make_pair()
    with torch.no_grad():
        outs = p["model"].eval()(p["batch"])
    print("max|logits port - jax|", max(float(np.abs(g.float().numpy() - w).max())
                                       for g, w in zip(outs, p["outs"])))
    skipped, loss_err, grad_err, finite, per = step_errors(p)
    print(f"loss relative difference {loss_err:.3g}, gradients' joint norm-relative "
          f"difference {grad_err:.3g}, finite {finite}")
    for name in sorted(per, key=lambda n: -per[n])[:5]:
        print(f"  {name}: norm-relative {per[name]:.3g}")
