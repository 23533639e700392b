"""The port's sparse GloVe-table optimizer (``parallel/sparse_table.py`` and
the sparse path of ``parallel/train_step.py``) against the TPU package's.

Same weights (JAX params perturbed with numpy noise, carried by
``models/convert.py``), the same numpy batches, float32 on the CPU, dropout
0. One jitted JAX sparse step serves the module. Checks:

* ``_dedup_ids`` and ``remap_batch`` equal JAX's value for value, obj-only
  and obj+rel (``micro_pos_rel`` is embedded too);
* the forward on the (U, D) row block equals the dense forward (1e-6), every
  lookup of the shared table sees the block, and the table is back in place
  afterwards;
* the first sparse step equals the dense Adam step on the touched rows
  (2e-6, as the TPU package's test holds it) and leaves the untouched rows
  and every other parameter bitwise as the dense step does;
* 20 sparse steps with warmup track JAX's: losses, params, table rows and
  the moments within 1e-4, ``count`` equal;
* a poisoned batch changes nothing, ``count`` included;
* bf16 moments track JAX's bf16 moments (tolerances below);
* ``TableOpt`` survives a checkpoint round trip; ``ValueError`` without
  ``share_glove`` and with ``int8_serving``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.parallel import sparse_table as jax_sparse
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam
from structured_alignment_vqa_tpu.parallel.train_step import create_train_state as jax_state
from structured_alignment_vqa_tpu.parallel.train_step import make_train_step as jax_train_step
from structured_alignment_vqa_tpu_torch.data.synthetic import batch_from_arrays, synthetic_arrays
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.convert import (
    state_dict_from_jax,
    table_opt_from_jax,
)
from structured_alignment_vqa_tpu_torch.parallel import sparse_table
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    TrainState,
    adam,
    create_train_state,
    make_train_step,
)
from structured_alignment_vqa_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_model import TINY, build_pair, jax_batch

FORWARD_ATOL = 1e-6     # the block's forward against the dense one
FIRST_STEP_ATOL = 2e-6  # touched rows after one step, sparse against dense Adam
TRACK_ATOL = 1e-4       # 20 steps against JAX: losses, params, rows, f32 moments
LR = 1e-3
WARMUP = 5
# bf16 moments, 10 steps against JAX's bf16 moments. Each moment is rounded
# to bf16 after every update on both sides; an f32 difference of rounding
# size in the gradient can send one rounding the other way, one bf16 ulp:
# 2^-8 of the element. The table rows take 10 updates of at most lr each
# computed from those moments.
BF16_MOMENT_RTOL = 2 ** -7
BF16_TABLE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def _arrays(cfg, n, seed=30, size=3):
    return [synthetic_arrays(cfg, size, lv=4, lq=5, ls=10, n_rel=4, seed=seed + s)
            for s in range(n)]


@pytest.fixture(scope="module")
def jax_world():
    """The perturbed JAX params and the port model holding the same, and
    one jitted JAX sparse step with a 5-step warmup."""
    torch.set_num_threads(1)
    jmodel, jparams, jb, model, _ = build_pair(TINY, True, False)
    tx = jax_adam(LR, warmup_steps=WARMUP)
    jstep = jax_train_step(jmodel, tx, jmodel.cfg, sparse_table=True, table_lr=LR,
                           table_warmup_steps=WARMUP)
    return dict(jmodel=jmodel, jparams=jparams, jb=jb, tx=tx, jstep=jstep,
                weights={k: v.clone() for k, v in model.state_dict().items()})


def _port(weights, cfg=None, sparse=True, moments=torch.float32, warmup=WARMUP):
    cfg = cfg or ModelConfig(share_glove=True, **TINY)
    model = AttModelX3(cfg, device="cpu")
    model.load_state_dict(weights)
    state = create_train_state(model, LR, warmup, sparse_table=sparse,
                               table_moments_dtype=moments)
    step = make_train_step(model, state.optimizer, cfg, sparse_table=sparse)
    return model, state, step


def _jax_state(w, moments=jnp.float32):
    state = jax_state(w["jmodel"], jax.random.key(0), w["jb"], w["tx"], sparse_table=True,
                      table_moments_dtype=moments)
    # a copy: the jitted step donates its state
    return state.replace(params=jax.tree.map(jnp.array, w["jparams"]))


def _table(model):
    return model.MIL_NCE.syb_emb.weight


@pytest.mark.parametrize("only_obj", [True, False], ids=["obj", "obj_rel"])
def test_dedup_and_remap_equal_jax_value_for_value(only_obj):
    jcfg = JaxConfig(share_glove=True, **dict(TINY, only_obj=only_obj))
    cfg = ModelConfig(share_glove=True, **dict(TINY, only_obj=only_obj))
    for arrays in _arrays(cfg, 3):
        jrb, juids, jvalid = jax_sparse.remap_batch(jax_batch(arrays), jcfg)
        batch = batch_from_arrays(arrays, "cpu")
        rb, uids, valid = sparse_table.remap_batch(batch, cfg)
        np.testing.assert_array_equal(uids.numpy(), np.asarray(juids))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert 0 < int(valid.sum()) < len(valid)
        fields = sparse_table.table_id_fields(only_obj)
        assert ("micro_pos_rel" in fields) == (not only_obj)
        assert fields == jax_sparse.table_id_fields(only_obj)
        for f in fields:
            got = getattr(rb, f)
            assert got.dtype == getattr(batch, f).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jrb, f)), err_msg=f)
            np.testing.assert_array_equal(uids[got].numpy(), getattr(batch, f).numpy())
        flat = np.concatenate([arrays[f].reshape(-1) for f in fields])
        ju, jinv, jv = jax_sparse._dedup_ids(jnp.asarray(flat, jnp.int32), cfg.vocab_size)
        u, inv, v = sparse_table._dedup_ids(torch.from_numpy(flat).long(), cfg.vocab_size)
        for a, b in ((u, ju), (inv, jinv), (v, jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_block_forward_equals_dense_and_every_lookup_sees_the_block(jax_world):
    model, state, _ = _port(jax_world["weights"])
    cfg = model.cfg
    batch = batch_from_arrays(_arrays(cfg, 1)[0], "cpu")
    table = _table(model)
    model.eval()
    with torch.no_grad():
        want = model(batch)
        rb, uids, _ = sparse_table.remap_batch(batch, cfg)
        rows = table.detach()[uids]
        seen = []
        hook = model.MIL_NCE.syb_emb.register_forward_pre_hook(
            lambda m, args: seen.append(m.weight is rows))
        try:
            got = torch.func.functional_call(model, {sparse_table.TABLE_NAME: rows}, (rb, None),
                                             tie_weights=False)
        finally:
            hook.remove()
    # MIL_NCE looks up macro_ipt and both object candidates, each encoder q_ipt
    assert seen == [True] * 5
    assert model.att_vis_grid.syb_emb is model.att_syb.syb_emb is model.MIL_NCE.syb_emb
    assert _table(model) is table and table.shape[0] == cfg.vocab_size
    for name, a, b in zip(("concat", "vis", "syb", "mil_obj"), want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=FORWARD_ATOL, rtol=0, err_msg=name)


def test_first_sparse_step_is_dense_adam_on_touched_rows(jax_world):
    weights = jax_world["weights"]
    dmodel, dstate, dstep = _port(weights, sparse=False, warmup=0)
    smodel, sstate, sstep = _port(weights, warmup=0)
    batch = batch_from_arrays(_arrays(smodel.cfg, 1, seed=40)[0], "cpu")
    _, uids, valid = sparse_table.remap_batch(batch, smodel.cfg)
    touched = uids[valid]
    param = _table(smodel)
    t0 = param.detach().clone()
    dm, sm = dstep(dstate, batch), sstep(sstate, batch)
    assert _table(smodel) is param     # the step put the table back in place
    assert dm["loss"].item() == sm["loss"].item()
    dense, sparse = _table(dmodel).detach(), _table(smodel).detach()
    np.testing.assert_allclose(sparse[touched].numpy(), dense[touched].numpy(),
                               atol=FIRST_STEP_ATOL, rtol=0)
    assert not torch.equal(sparse[touched], t0[touched])
    untouched = torch.ones(len(t0), dtype=torch.bool)
    untouched[touched] = False
    assert torch.equal(sparse[untouched], t0[untouched])
    assert torch.equal(dense[untouched], t0[untouched])
    d = dict(dmodel.named_parameters())
    for name, p in smodel.named_parameters():
        if name != sparse_table.TABLE_NAME:
            assert torch.equal(p, d[name]), name
    assert int(sstate.table_opt.count) == 1 == dstate.optimizer.param_groups[0]["updates"]
    assert not any(p is _table(smodel) for g in sstate.optimizer.param_groups
                   for p in g["params"])


def _track(jax_world, moments, n_steps):
    cfg = ModelConfig(share_glove=True, **TINY)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[moments]
    jstate = _jax_state(jax_world, jdtype)
    model, state, step = _port(jax_world["weights"], moments=moments)
    arrays = _arrays(cfg, 4, seed=50)
    for i in range(n_steps):
        a = arrays[i % len(arrays)]
        jstate, jm = jax_world["jstep"](jstate, jax_batch(a), jax.random.key(1))
        m = step(state, batch_from_arrays(a, "cpu"))
        assert m["skipped"].item() == float(jm["skipped"]) == 0.0
        for key in ("loss", "ce", "mil_nce_loss"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=TRACK_ATOL, rtol=0,
                                       err_msg=f"step {i} {key}")
    return model, state, jstate


def test_twenty_sparse_steps_track_jax(jax_world):
    model, state, jstate = _track(jax_world, torch.float32, 20)
    want = state_dict_from_jax(jax.device_get(jstate.params), TINY["num_blocks"])
    got = model.state_dict()
    moved = (got[sparse_table.TABLE_NAME] - jax_world["weights"][sparse_table.TABLE_NAME]).abs()
    assert moved.max() > 1e-3
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=TRACK_ATOL, rtol=0,
                                   err_msg=name)
    topt = table_opt_from_jax(jax.device_get(jstate.opt_state[1]))
    assert int(state.table_opt.count) == int(topt["count"]) == 20
    for key in ("mu", "nu"):
        np.testing.assert_allclose(getattr(state.table_opt, key).numpy(), topt[key].numpy(),
                                   atol=TRACK_ATOL, rtol=0, err_msg=key)


def test_warmup_starts_the_table_at_rate_zero(jax_world):
    model, state, step = _port(jax_world["weights"])
    batch = batch_from_arrays(_arrays(model.cfg, 1)[0], "cpu")
    t0 = _table(model).detach().clone()
    step(state, batch)
    assert torch.equal(_table(model), t0) and int(state.table_opt.count) == 1
    assert state.table_opt.mu.abs().max() > 0
    step(state, batch)
    assert not torch.equal(_table(model), t0) and int(state.table_opt.count) == 2


def test_poisoned_batch_changes_nothing_count_included(jax_world):
    model, state, step = _port(jax_world["weights"])
    batch = batch_from_arrays(_arrays(model.cfg, 1)[0], "cpu")
    step(state, batch)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    topt = {k: getattr(state.table_opt, k).clone() for k in ("count", "mu", "nu")}
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in state.optimizer.state_dict()["state"].items()}
    vis = batch.vis_fea.clone()
    vis[0, 0, 0] = float("nan")
    m = step(state, dataclasses.replace(batch, vis_fea=vis))
    assert m["skipped"].item() == 1.0 and state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, v in topt.items():
        assert torch.equal(getattr(state.table_opt, k), v), k
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt[i][k]), (i, k)
    assert step(state, batch)["skipped"].item() == 0.0
    assert int(state.table_opt.count) == 2


def test_bf16_moments_track_jax_bf16_moments(jax_world):
    model, state, jstate = _track(jax_world, torch.bfloat16, 10)
    assert state.table_opt.mu.dtype == state.table_opt.nu.dtype == torch.bfloat16
    want = state_dict_from_jax(jax.device_get(jstate.params), TINY["num_blocks"])
    name = sparse_table.TABLE_NAME
    np.testing.assert_allclose(model.state_dict()[name].numpy(), want[name].numpy(),
                               atol=BF16_TABLE_ATOL, rtol=0)
    topt = table_opt_from_jax(jax.device_get(jstate.opt_state[1]))
    assert topt["mu"].dtype == torch.bfloat16 and int(topt["count"]) == 10
    for key in ("mu", "nu"):
        got, ref = getattr(state.table_opt, key).float(), topt[key].float()
        assert ref.abs().max() > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=BF16_MOMENT_RTOL,
                                   atol=1e-30, err_msg=key)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_table_opt_survives_a_checkpoint_round_trip(jax_world, tmp_path, moments):
    model, state, step = _port(jax_world["weights"], moments=moments)
    batch = batch_from_arrays(_arrays(model.cfg, 1)[0], "cpu")
    for _ in range(2):
        step(state, batch)
    gen = torch.Generator().manual_seed(3)
    ckpt.save_checkpoint(str(tmp_path), state, 1, generator=gen)
    saved = {k: getattr(state.table_opt, k).clone() for k in ("count", "mu", "nu")}
    table = _table(model).detach().clone()
    draw = torch.rand(4, generator=gen)
    step(state, batch)
    _, fresh, _ = _port(jax_world["weights"], moments=moments)
    fresh, epoch = ckpt.restore_checkpoint(str(tmp_path), fresh, generator=gen)
    assert epoch == 1 and fresh.step == 2
    for k, v in saved.items():
        got = getattr(fresh.table_opt, k)
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert torch.equal(_table(fresh.model), table)
    assert torch.equal(torch.rand(4, generator=gen), draw)
    _, other, _ = _port(jax_world["weights"], moments=torch.float32 if moments == torch.bfloat16
                        else torch.bfloat16)
    with pytest.raises(ValueError, match="table moments"):
        ckpt.restore_checkpoint(str(tmp_path), other)
    dense = TrainState(fresh.model, adam(fresh.model.parameters()))
    with pytest.raises(ValueError, match="sparse table"):
        ckpt.restore_checkpoint(str(tmp_path), dense)


def test_sparse_table_needs_share_glove_and_no_int8():
    model = AttModelX3(ModelConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="share_glove"):
        create_train_state(model, sparse_table=True)
    with pytest.raises(ValueError, match="share_glove"):
        make_train_step(model, adam(model.parameters()), model.cfg, sparse_table=True)
    cfg = ModelConfig(share_glove=True, int8_serving=True, **TINY)
    with pytest.raises(ValueError, match="int8"):
        make_train_step(model, adam(model.parameters()), cfg, sparse_table=True)
