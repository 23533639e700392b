"""The port's MCB head (compact bilinear pooling) against the TPU package's.

On the CPU, float32, dropout 0 where the two are compared: the count sketch
bitwise from the same generator; the pooling within 1e-5 on (B, D) and
(B, K, D), a padding row of zeros included (it takes part in the norm over
the batch axis); the MCB model's logits within 1e-4, unpacked and packed,
with the sketches a model built from a seed holds bitwise JAX's; one
training step's gradients within 1e-4 with the sketches untouched; int8
serving; the checkpoint; and the predict and eval CLIs with ``--mcb``
against the TPU package's.

The CLIs run at hidden 512, the production width. The pooling normalizes
each of its 16,000 outputs over the batch axis; at a narrow width (hidden
16 or 256 into 16,000 bins) an output can be near 0 on every row of a small
batch, so the division blows float32 rounding of the FFT up to O(1), and
JAX's FFT and torch's give different results (each as far from a float64
pooling). At hidden 512 each bin sums about 16 products and the two agree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.ops import mcb as jax_mcb
from structured_alignment_vqa_tpu.ops import quant as jax_quant
from structured_alignment_vqa_tpu.train import evaluate as jax_evaluate
from structured_alignment_vqa_tpu.train import losses as jax_losses
from structured_alignment_vqa_tpu.train import predict as jax_predict
from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.att_model_x3 import MCB_SKETCH_SEED
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.ops import mcb
from structured_alignment_vqa_tpu_torch.ops.quant import quantize_state_dict
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam, make_train_step
from structured_alignment_vqa_tpu_torch.train import evaluate, predict
from structured_alignment_vqa_tpu_torch.train.predict import ensemble_log_softmax
from structured_alignment_vqa_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_cli import build_world, read_jsonl
from test_torch_port_model import TINY, jax_batch, perturbed
from test_torch_port_packing import packed_model_pair

POOL_ATOL = 1e-5
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-4
LOSS_ATOL = 1e-4
TIE_GAP = 1e-4
MCB_KW = dict(TINY, use_mcb=True, mcb_out=24, dropout_rate_mcb=0.0)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def test_count_sketch_matrix_is_bitwise_jax():
    for dims in ((16, 24), (512, 16000)):
        a, b = np.random.default_rng(12345), np.random.default_rng(12345)
        for _ in range(2):             # sketch1, then sketch2 from the same generator
            got, want = mcb.count_sketch_matrix(a, *dims), jax_mcb.count_sketch_matrix(b, *dims)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert (np.abs(got).sum(axis=1) == 1).all()


@pytest.mark.parametrize("lead", [(5,), (5, 3)], ids=["B_D", "B_K_D"])
def test_compact_bilinear_pooling_matches_jax(lead):
    rng = np.random.default_rng(1)
    d, out = 16, 24
    x1 = rng.standard_normal(lead + (d,)).astype(np.float32)
    x2 = rng.standard_normal(lead + (d,)).astype(np.float32)
    x1[-1] = x2[-1] = 0.0                 # a padding row, inside the dim-0 norm
    s1 = mcb.count_sketch_matrix(rng, d, out)
    s2 = mcb.count_sketch_matrix(rng, d, out)
    got = mcb.compact_bilinear_pooling(*map(torch.from_numpy, (x1, x2, s1, s2)), out)
    want = jax_mcb.compact_bilinear_pooling(*map(jnp.asarray, (x1, x2, s1, s2)), out)
    assert got.dtype == torch.float32 and got.shape == lead + (out,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POOL_ATOL, rtol=0)
    assert not got[-1].any()
    np.testing.assert_allclose((got ** 2).sum(0).numpy(), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def mcb_pair():
    """The JAX MCB model on a synthetic batch, its perturbed params and its
    constants, and the port model holding the same."""
    torch.set_num_threads(1)
    cfg = ModelConfig(**MCB_KW)
    arrays = synthetic_arrays(cfg, 3, lv=4, lq=5, ls=10, seed=7)
    jb = jax_batch(arrays)
    jmodel = JaxModel(JaxConfig(**MCB_KW))
    variables = jax.jit(jmodel.init)(jax.random.key(0), jb)
    params, jparams = perturbed(variables["params"])
    constants = jax.device_get(variables["constants"])
    model = AttModelX3(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg.num_blocks, constants), strict=True)
    return dict(jmodel=jmodel, params=params, variables={"params": jparams,
                                                         "constants": constants},
                jb=jb, model=model.eval(), batch=batch_from_arrays(arrays, "cpu"))


def assert_logits_match(want, got, atol=LOGIT_ATOL):
    for name, w, g in zip(("concat", "vis", "syb", "mil_obj"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0, err_msg=name)


def test_mcb_logits_match_jax(mcb_pair):
    p = mcb_pair
    want = jax.jit(p["jmodel"].apply)(p["variables"], p["jb"])
    with torch.no_grad():
        got = p["model"](p["batch"])
    assert got[0].shape == (3, MCB_KW["num_classes"])
    assert_logits_match(want, got)


def test_packed_mcb_logits_match_jax():
    jmodel, variables, jb, model, pb = packed_model_pair(
        dict(use_mcb=True, mcb_out=24, dropout_rate_mcb=0.0))
    want = jax.jit(jmodel.apply)(variables, jb)
    with torch.no_grad():
        got = model(pb)
    assert got[0].shape == (4, 2, 7)
    assert_logits_match(want, got)


def test_a_port_model_from_a_seed_holds_the_jax_sketches(mcb_pair):
    """No conversion: the port draws the sketches JAX draws (the JAX
    model's default mcb_sketch_seed), at the test width and at full width."""
    constants = mcb_pair["variables"]["constants"]
    assert MCB_SKETCH_SEED == JaxModel(JaxConfig(**MCB_KW)).mcb_sketch_seed
    fresh = AttModelX3(ModelConfig(**MCB_KW), device="cpu")
    for name in ("sketch1", "sketch2"):
        np.testing.assert_array_equal(getattr(fresh.mcb, name).numpy(), constants[name])
    assert not any(n.startswith("mcb.") for n, _ in fresh.named_parameters())
    assert {"mcb.sketch1", "mcb.sketch2"} <= set(fresh.state_dict())
    full = AttModelX3(ModelConfig(**dict(MCB_KW, hidden_size=512, num_heads=8,
                                         mcb_out=16000)), device="cpu").mcb
    rng = np.random.default_rng(MCB_SKETCH_SEED)
    for name in ("sketch1", "sketch2"):
        np.testing.assert_array_equal(getattr(full, name).numpy(),
                                      jax_mcb.count_sketch_matrix(rng, 512, 16000))


def test_one_mcb_step_matches_jax_and_leaves_the_sketches(mcb_pair):
    p = mcb_pair
    jmodel, constants = p["jmodel"], p["variables"]["constants"]

    def loss_fn(params, jb):
        lc, lv, ls, mo, mr = jmodel.apply({"params": params, "constants": constants}, jb)
        ce, _ = jax_losses.ensemble_smoothed_ce(lc, lv, ls, jb.answer, jb.sample_valid, 0.1)
        return ce + jax_losses.mil_nce_loss(mo, mr, True)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(p["variables"]["params"], p["jb"])
    model = AttModelX3(ModelConfig(**MCB_KW), device="cpu")
    model.load_state_dict(p["model"].state_dict())
    sketches = [model.mcb.sketch1.clone(), model.mcb.sketch2.clone()]
    opt = adam(model.parameters())
    m = make_train_step(model, opt, model.cfg)(TrainState(model, opt), p["batch"])
    np.testing.assert_allclose(m["loss"].item(), float(jloss), atol=LOSS_ATOL, rtol=0)
    want = state_dict_from_jax(jax.device_get(jgrads), MCB_KW["num_blocks"])
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want) and "cls_mcb.0.weight" in named
    for name, param in named.items():
        w = want[name]
        g = torch.zeros_like(param) if param.grad is None else param.grad
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
        assert err <= GRAD_RTOL, (name, err)
    assert model.cls_mcb[0].weight.grad.abs().max() > 0
    assert torch.equal(model.mcb.sketch1, sketches[0])
    assert torch.equal(model.mcb.sketch2, sketches[1])


def test_int8_mcb_logits_match_jax_int8(mcb_pair):
    p = mcb_pair
    qtree = jax_quant.quantize_params(p["params"])
    jq = JaxModel(JaxConfig(int8_serving=True, **MCB_KW))
    want = jax.jit(jq.apply)({"params": qtree, "constants": p["variables"]["constants"]},
                             p["jb"])
    model = AttModelX3(ModelConfig(int8_serving=True, **MCB_KW), device="cpu").eval()
    sd = quantize_state_dict(p["model"].state_dict())
    assert sd["cls_mcb.0.weight_q"].dtype == torch.int8
    assert sd["mcb.sketch1"].dtype == torch.float32
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(p["batch"])
    assert_logits_match(want, got)


def test_the_checkpoint_round_trips_the_sketches(mcb_pair, tmp_path):
    model = mcb_pair["model"]
    ckpt.save_checkpoint(str(tmp_path), TrainState(model, adam(model.parameters())), 1)
    fresh = AttModelX3(ModelConfig(**MCB_KW), device="cpu")
    with torch.no_grad():            # so that only the checkpoint can restore them
        fresh.mcb.sketch1.zero_()
        fresh.mcb.sketch2.neg_()
    assert not torch.equal(fresh.mcb.sketch2, model.mcb.sketch2)
    ckpt.load_params_for_eval(str(tmp_path), fresh)
    for name, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t), name


@pytest.fixture(scope="module")
def mcb_world(tmp_path_factory):
    return build_world(tmp_path_factory.mktemp("mcb_cli"), ["--mcb", "--hidden_size", "512"])


def test_predict_and_eval_clis_with_mcb_give_the_jax_clis_answers_and_loss(mcb_world):
    w = mcb_world
    assert w["model"].cfg.use_mcb and w["model"].cfg.mcb_out == 16000
    assert set(w["constants"]) == {"sketch1", "sketch2"}
    args = w["args"] + ["--split", "train"]
    outs = [str(w["tmp"] / f"{name}.jsonl") for name in ("jax", "port")]
    n_jax = jax_predict.main(args + ["--weight_dir", w["jax_ckpt"], "--out", outs[0]])
    n_port = predict.main(args + ["--weight_dir", w["port_ckpt"], "--out", outs[1]])
    want, got = (read_jsonl(o) for o in outs)
    assert n_jax == n_port == len(want) == len(got) > 0
    # a differing answer is allowed only where the port's top two scores tie
    gaps = []
    loader = BatchLoader(GQASuperNodeDataset("train", w["ptrain_dc"]), 4, shuffle=False,
                         drop_last=False, num_threads=2)
    with torch.inference_mode():
        for b in loader:
            top2 = torch.sort(ensemble_log_softmax(w["model"], host_tensors(b)), -1)[0][:, -2:]
            gaps += [float(g[1] - g[0]) for g, ok in zip(top2, b.sample_valid) if ok]
    assert len(gaps) == len(got)
    assert all(gaps[i] < TIE_GAP for i, (a, b) in enumerate(zip(want, got)) if a != b)
    jloss, jacc = jax_evaluate.main(args + ["--weight_dir", w["jax_ckpt"]])
    ploss, pacc = evaluate.main(args + ["--weight_dir", w["port_ckpt"]])
    assert np.isfinite(ploss) and abs(ploss - float(jloss)) <= LOSS_ATOL
    assert pacc == float(jacc)
    assert os.path.exists(os.path.join(w["port_ckpt"], "epoch_1.pt"))
