"""The port's int8 weight-only serving (``ops/quant.py``, the int8 layout of
``GloVeEmbed`` and the heads, ``predict --int8``) against the TPU package's,
float32 on the CPU:

* ``quantize_int8`` is bitwise JAX's, per row and per column, zero rows too;
* ``quantize_state_dict`` quantizes exactly what ``quantize_params``
  quantizes, bitwise (carried across by ``models/convert.py``), and raises
  where it raises;
* the int8 model's logits agree with JAX's ``int8_serving`` model within
  1e-4, with equal answers, on one tree of weights (shared table and not);
* the predict CLI with ``--int8`` writes the JAX CLI's answers on a fixture
  tree from the same float weights.
"""

import os

import jax
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.ops import quant as jax_quant
from structured_alignment_vqa_tpu.train import predict as jax_predict
from structured_alignment_vqa_tpu.train.predict import make_predict_step as jax_predict_step
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.ops import quant
from structured_alignment_vqa_tpu_torch.train import predict
from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step
from test_torch_port_cli import read_jsonl, world  # noqa: F401  (world is a fixture)
from test_torch_port_model import TINY, _State, build_pair

LOGIT_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def test_quantize_int8_is_bitwise_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 24)).astype(np.float32) * 3
    w[5] = 0.0
    w[:, 7] = 0.0
    w[9, :4] = [127.0, -254.0, 0.5, 1e-30]
    for axis in (0, 1):
        q, s = quant.quantize_int8(w, axis)
        jq, js = jax_quant.quantize_int8(w, axis)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))


@pytest.fixture(scope="module")
def pairs():
    """build_pair for separate and shared tables: JAX model, perturbed
    params, batches; the port model is built again where needed."""
    torch.set_num_threads(1)
    return {sg: build_pair(TINY, sg, False) for sg in (False, True)}


@pytest.mark.parametrize("share_glove", [False, True], ids=["tables", "shared"])
def test_quantize_state_dict_quantizes_what_quantize_params_does(pairs, share_glove):
    tree = jax.device_get(pairs[share_glove][1])
    want = state_dict_from_jax(jax_quant.quantize_params(tree), TINY["num_blocks"])
    got = quant.quantize_state_dict(state_dict_from_jax(tree, TINY["num_blocks"]))
    assert sorted(got) == sorted(want)
    n_q = 0
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), w.numpy(), err_msg=name)
        n_q += w.dtype == torch.int8
    assert n_q == 3 + 6            # three table names (shared: one tensor) and six head layers
    qmodel = AttModelX3(ModelConfig(share_glove=share_glove, int8_serving=True, **TINY),
                        device="cpu")
    qmodel.load_state_dict(got, strict=True)


def test_quantize_state_dict_raises_where_quantize_params_raises(pairs):
    tree = jax.device_get(pairs[True][1])
    sd = state_dict_from_jax(tree, TINY["num_blocks"])
    again = jax_quant.quantize_params(tree)
    with pytest.raises(ValueError, match="already quantized|expected"):
        jax_quant.quantize_params(again)
    with pytest.raises(ValueError, match="already quantized|expected"):
        quant.quantize_state_dict(quant.quantize_state_dict(sd))
    headless = {k: v for k, v in tree.items() if not k.startswith("cls")}
    with pytest.raises(ValueError, match="matched"):
        jax_quant.quantize_params(headless)
    with pytest.raises(ValueError, match="matched"):
        quant.quantize_state_dict({k: v for k, v in sd.items() if not k.startswith("cls")})
    odd = dict(tree, cls_out=dict(tree["cls_out"], extra=tree["cls_out"]["bias"]))
    with pytest.raises(ValueError, match="classifier head"):
        jax_quant.quantize_params(odd)
    with pytest.raises(ValueError, match="classifier head"):
        quant.quantize_state_dict(dict(sd, **{"cls.3.extra": sd["cls.3.bias"]}))


@pytest.mark.parametrize("share_glove", [False, True], ids=["tables", "shared"])
def test_int8_logits_agree_with_jax_int8_model(pairs, share_glove):
    _, jparams, jb, _, batch = pairs[share_glove]
    qtree = jax_quant.quantize_params(jax.device_get(jparams))
    jq = JaxModel(JaxConfig(share_glove=share_glove, int8_serving=True, **TINY))
    want = jax.jit(jq.apply)({"params": qtree}, jb)
    cfg = ModelConfig(share_glove=share_glove, int8_serving=True, **TINY)
    model = AttModelX3(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(qtree, TINY["num_blocks"]), strict=True)
    assert not any(p.dtype == torch.int8 for p in model.parameters())
    assert model.MIL_NCE.syb_emb.weight_q.dtype == model.cls[3].weight_q.dtype == torch.int8
    with torch.no_grad():
        got = model(batch)
    for name, w, g in zip(("concat", "vis", "syb", "mil_obj"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=name)
    answers = np.asarray(jax_predict_step(jq)(_State(params=qtree, constants={}), jb))
    np.testing.assert_array_equal(make_predict_step(model)(batch).numpy(), answers)


def test_predict_cli_int8_writes_the_jax_cli_answers(world):  # noqa: F811
    tmp, args = world["tmp"], world["args"]
    extra = ["--split", "train", "--int8"]
    jax_out, port_out = str(tmp / "jax8.jsonl"), str(tmp / "port8.jsonl")
    n_jax = jax_predict.main(args + ["--weight_dir", world["jax_ckpt"], "--out", jax_out]
                             + extra)
    n_port = predict.main(args + ["--weight_dir", world["port_ckpt"], "--out", port_out]
                          + extra)
    want, got = read_jsonl(jax_out), read_jsonl(port_out)
    assert n_jax == n_port == len(want) == len(got) > 0
    assert got == want
    float_out = str(tmp / "port_f32.jsonl")
    predict.main(args + ["--weight_dir", world["port_ckpt"], "--out", float_out,
                         "--split", "train"])
    assert os.path.getsize(float_out) > 0
    same = sum(a == b for a, b in zip(read_jsonl(float_out), got))
    print(f"\npredict CLI --int8: {same} of {len(got)} answers as in float32")
