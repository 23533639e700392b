"""The PyTorch port's AttModelX3 serving forward against the JAX package.

Both models get the same weights: the JAX params are perturbed with numpy
noise (off the LayerNorm knife edge, docs/PARITY.md) and carried into the
port by ``models/convert.py``. Both see the same numpy batch. Everything is
float32 on the CPU; logits agree within 1e-4 (the port's attention and FFN
run their kernels' plain versions, which sum in another order than XLA).
"""

from typing import Any

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.data.batch import VQABatch as JaxBatch
from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.models import att_model_x3 as jax_x3
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.models.torch_export import export_state_dict
from structured_alignment_vqa_tpu.train.predict import make_predict_step as jax_predict_step
from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models import att_model_x3 as port_x3
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.parallel.mesh import check_axes
from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step

LOGIT_ATOL = 1e-4

TINY = dict(
    num_classes=11, num_relations=7, vocab_size=50, glove_dim=12, vis_fea_dim=16,
    hidden_size=16, hidden_size_mil=8, num_blocks=3, num_heads=2, dropout_rate=0.0,
    maxlen=32, maxlen_q=8, maxlen_v=6, topn=2, stage1_blocks=1, stage2_blocks=2,
)
OBJ_REL = dict(TINY, only_obj=False)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


@flax.struct.dataclass
class _State:
    params: Any
    constants: Any


def jax_batch(arrays):
    return JaxBatch(**{
        k: jnp.asarray(v.astype(np.int32) if np.issubdtype(v.dtype, np.integer) else v)
        for k, v in arrays.items()
    })


def perturbed(params, seed=5, scale=0.05):
    """Numpy noise on every param; returns (numpy tree, the same as jnp arrays)."""
    rng = np.random.default_rng(seed)
    noisy = jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(params),
    )
    return noisy, jax.tree.map(jnp.asarray, noisy)


def build_pair(kw, share_glove, use_pallas, batch=3, bucket=(4, 5, 10), seed=7):
    jcfg = JaxConfig(share_glove=share_glove, use_pallas_attention=use_pallas, **kw)
    pcfg = ModelConfig(share_glove=share_glove, **kw)
    lv, lq, ls = bucket
    arrays = synthetic_arrays(pcfg, batch, lv=lv, lq=lq, ls=ls, seed=seed)
    jb = jax_batch(arrays)
    jmodel = JaxModel(jcfg)
    params, jparams = perturbed(jmodel.init(jax.random.key(0), jb)["params"])
    model = AttModelX3(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, pcfg.num_blocks), strict=True)
    model.eval()
    return jmodel, jparams, jb, model, batch_from_arrays(arrays, "cpu")


def assert_forward_matches(jmodel, params, jb, model, batch):
    want = jax.jit(jmodel.apply)({"params": params}, jb)
    with torch.no_grad():
        got = model(batch)
    for name, w, g in zip(("logits_concat", "logits_vis", "logits_syb", "mil_obj"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL, rtol=0, err_msg=name)
    state = _State(params=params, constants={})
    answers = np.asarray(jax_predict_step(jmodel)(state, jb))
    np.testing.assert_array_equal(make_predict_step(model)(batch).numpy(), answers)


@pytest.mark.parametrize("share_glove", [False, True], ids=["tables", "shared"])
def test_tiny_forward_and_answers_match_jax(share_glove):
    """JAX runs its composite attention and FFN (use_pallas_attention=False);
    test_torch_port_model_wide.py covers its Pallas kernels."""
    assert_forward_matches(*build_pair(TINY, share_glove, False))


@pytest.mark.parametrize("share_glove", [False, True], ids=["tables", "shared"])
def test_convert_equals_export_state_dict(share_glove):
    _assert_convert_equals_export(TINY, share_glove)


def _assert_convert_equals_export(kw, share_glove):
    jmodel, params, _, model, _ = build_pair(kw, share_glove, False)
    params = jax.device_get(params)
    ours = state_dict_from_jax(params, kw["num_blocks"])
    theirs = export_state_dict({"params": params}, kw["num_blocks"], ddp_prefix=False,
                               only_obj=kw.get("only_obj", True))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    AttModelX3(ModelConfig(share_glove=share_glove, **kw), device="cpu").load_state_dict(
        theirs, strict=True)
    assert sorted(model.state_dict()) == sorted(theirs)
    return ours


def test_convert_carries_the_relation_tensor():
    """obj+rel: ``MIL_NCE.R`` goes over untransposed; obj-only has none."""
    ours = _assert_convert_equals_export(OBJ_REL, True)
    assert tuple(ours["MIL_NCE.R"].shape) == (TINY["num_relations"], 8, 8)
    assert "MIL_NCE.R" not in AttModelX3(ModelConfig(**TINY), device="cpu").state_dict()


def test_tiny_obj_rel_forward_and_answers_match_jax():
    """only_obj=False at a short bucket: the relation branch feeds the
    symbolic encoder and mil_rel is live; K1's plain version serves every
    graph attention (the flash path is test_torch_port_mil_nce_rel.py's)."""
    pair = build_pair(OBJ_REL, True, False)
    assert_forward_matches(*pair)
    jmodel, params, jb, model, batch = pair
    want = jax.jit(jmodel.apply)({"params": params}, jb)[4]
    with torch.no_grad():
        got = model(batch)[4]
    np.testing.assert_allclose(got.item(), float(want), atol=LOGIT_ATOL, rtol=0)
    assert got.item() != 0.0


@pytest.mark.parametrize("use_dec_mask", [True, False])
@pytest.mark.parametrize("with_graph", [True, False], ids=["graph", "dense"])
def test_build_stage_graphs_matches_jax(rng, use_dec_mask, with_graph):
    b, lm, lq = 3, 5, 4
    mm = (rng.random((b, lm, lm)) > 0.3).astype(np.int32)
    qm = (rng.random((b, lq, lq)) > 0.3).astype(np.int32)
    qg = (rng.random((b, lq, lq)) > 0.5).astype(np.int32)
    mg = (rng.random((b, lm, lm)) > 0.5).astype(np.int32) if with_graph else None
    want = jax_x3.build_stage_graphs(
        jnp.asarray(mm), jnp.asarray(qm), jnp.asarray(qg),
        None if mg is None else jnp.asarray(mg), use_dec_mask)
    got = port_x3.build_stage_graphs(
        torch.from_numpy(mm), torch.from_numpy(qm), torch.from_numpy(qg),
        None if mg is None else torch.from_numpy(mg), use_dec_mask)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mil_object_branch_matches_jax():
    jmodel, params, jb, model, batch = build_pair(TINY, False, False)
    mil = jax_x3.MILNCEModule(JaxConfig(**TINY))
    want_macro, want_obj, _ = mil.apply(
        {"params": params["mil_nce"]}, jb.vis_fea, jb.macro_ipt, jb.macro_obj_loc,
        jb.micro_pos_obj, jb.micro_neg_obj, jb.micro_obj_mask, jb.micro_pos_rel,
        jb.micro_neg_rel, jb.micro_pos_rel_loc, jb.micro_neg_rel_loc)
    with torch.no_grad():
        got_macro, got_obj, got_rel = model.MIL_NCE(
            batch.vis_fea, batch.macro_ipt, batch.macro_obj_loc,
            batch.micro_pos_obj, batch.micro_neg_obj, batch.micro_obj_mask)
    np.testing.assert_allclose(got_macro.numpy(), np.asarray(want_macro), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_obj.item(), float(want_obj), atol=1e-6, rtol=0)
    assert got_rel.item() == 0.0


def test_synthetic_arrays_match_jax_synthetic_batch():
    from structured_alignment_vqa_tpu.data.synthetic import synthetic_batch as jax_synthetic
    from structured_alignment_vqa_tpu.models.config import tiny_test_config as jax_tiny

    arrays = synthetic_arrays(ModelConfig(**TINY), 4, lv=4, lq=5, ls=10, seed=3)
    jb = jax_synthetic(jax_tiny(), 4, lv=4, lq=5, ls=10, seed=3)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jb, name)), err_msg=name)


def test_batch_fields_match_jax_batch_and_move_with_to():
    arrays = synthetic_arrays(ModelConfig(**TINY), 3, lv=4, lq=5, ls=10, seed=2)
    batch = batch_from_arrays(arrays, "cpu")
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    assert (batch.batch_size, batch.n_pack) == (jb.batch_size, jb.n_pack) == (3, 1)
    moved = batch.to("cpu")
    assert moved.vis_seg is None
    for name, arr in arrays.items():
        np.testing.assert_array_equal(getattr(moved, name).numpy(), arr, err_msg=name)


@pytest.mark.parametrize("cfg_kw", [
    dict(seq_axis="seq"),
], ids=lambda kw: next(iter(kw)))
def test_unported_settings_raise(cfg_kw):
    # seq_axis is ported (ring and Ulysses attention, ROADMAP item 16): the
    # model builds with it; the model axis (item 15b) is ported too, and on
    # the mesh that seq_axis would run on a head split between ranks
    # (hidden 16 over model 4, 2 heads; item 15d) passes as well: only
    # sizes the mesh cannot take raise
    AttModelX3(ModelConfig(**TINY, **cfg_kw), device="cpu")
    check_axes(model_parallel=2, seq_parallel=2, hidden_size=16, num_heads=2)
    check_axes(model_parallel=4, seq_parallel=2, hidden_size=16, num_heads=2)
    with pytest.raises(ValueError, match="axis sizes must be >= 1"):
        check_axes(model_parallel=0, seq_parallel=2, hidden_size=16, num_heads=2)


@pytest.mark.parametrize("cfg_kw", [
    dict(only_obj=False), dict(remat_blocks=True), dict(only_obj=False, remat_blocks=True),
    dict(use_mcb=True, mcb_out=24),
], ids=lambda kw: "+".join(k for k in kw if k != "mcb_out"))
def test_ported_settings_build_and_run(cfg_kw):
    cfg = ModelConfig(**TINY, **cfg_kw)
    model = AttModelX3(cfg, device="cpu")
    assert hasattr(model.MIL_NCE, "R") == (not cfg.only_obj)
    assert hasattr(model, "cls") != cfg.use_mcb == hasattr(model, "cls_mcb")
    batch = batch_from_arrays(synthetic_arrays(cfg, 2, lv=4, lq=5, ls=10, seed=1), "cpu")
    out = model(batch)
    assert all(torch.isfinite(t).all() for t in out[:4])
    out[0].sum().backward()
    head = model.cls_mcb if cfg.use_mcb else model.cls
    assert head[3].weight.grad is not None


def test_packed_batch_raises():
    """A batch with some of the six packing fields and not the others, or
    with packing fields and (B,) answers, is neither packed nor unpacked."""
    cfg = ModelConfig(**TINY)
    arrays = synthetic_arrays(cfg, 2, lv=4, lq=5, ls=10, seed=1)
    arrays["vis_seg"] = np.zeros((2, 4), np.int64)
    with pytest.raises(ValueError, match="packed batch"):
        AttModelX3(cfg, device="cpu")(batch_from_arrays(arrays, "cpu"))
