"""The port's sequence packing against the TPU package's.

On the CPU, float32, dropout 0: ``PackedRow`` and ``collate_packed`` value
for value; the packed loader (``n_pack`` 2 and 4 into bucket 1, and
``tight=True``) batch for batch, through the batch cache, batch replay and
the sample cache too; the packed model's logits (B, n_pack, C) and MIL-NCE
terms within 1e-4 of the JAX model's on the same weights; each packed slot
equal to its sample collated alone (1e-5) and blind to the other slots'
content; one packed dense step's gradients and one packed sparse-table step
against JAX's; and int8 serving of a packed batch.
``test_torch_port_train_driver_jax.py`` holds ``train()`` with ``n_pack=2``
against the TPU package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.ops.pallas_attention as pa
from structured_alignment_vqa_tpu.data import batch_cache as jax_bc
from structured_alignment_vqa_tpu.data import dataset as jax_ds
from structured_alignment_vqa_tpu.data import packing as jax_packing
from structured_alignment_vqa_tpu.models import AttModelX3 as JaxModel
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.ops import quant as jax_quant
from structured_alignment_vqa_tpu.parallel.train_step import adam as jax_adam
from structured_alignment_vqa_tpu.parallel.train_step import create_train_state as jax_state
from structured_alignment_vqa_tpu.parallel.train_step import make_train_step as jax_train_step
from structured_alignment_vqa_tpu.train import losses as jax_losses
from structured_alignment_vqa_tpu.train.predict import make_predict_step as jax_predict_step
from structured_alignment_vqa_tpu_torch.data import batch_cache as port_bc
from structured_alignment_vqa_tpu_torch.data import dataset as port_ds
from structured_alignment_vqa_tpu_torch.data import packing
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.data.transfer import host_tensors
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.convert import GLOVE_SLOTS, state_dict_from_jax
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    TrainState,
    adam,
    create_train_state,
    make_train_step,
)
from structured_alignment_vqa_tpu_torch.train.predict import make_predict_step
from test_torch_port_model import TINY, _State, perturbed
from test_torch_port_train_step import _jax_loss

TOPN = 2
FEA_DIM = 16
SHAPE = (8, 20, 12)          # (lv, ls, lq) of the model tests' packed rows
LOGIT_ATOL = 1e-4            # the port against JAX: sums in another order
SLOT_ATOL = 1e-5             # a packed slot against its sample alone, in the port
SWAP_ATOL = 2e-5             # a slot whose neighbour's content changed
GRAD_RTOL = 1e-4             # one step's gradients, relative to each one's max |.|
STEP_ATOL = 1e-4             # a sparse step's loss and parameters against JAX's
# the packed model: one shared 401,000-row table, so that the PAD ids exist
KW = dict(TINY, vocab_size=401000, glove_dim=8, maxlen=64, maxlen_q=12, maxlen_v=8,
          num_classes=7, share_glove=True)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)
    pa.INTERPRET_MODE = True
    yield
    pa.INTERPRET_MODE = False


def sample_fields(rng, no, nm, nq, answer):
    """A structurally valid sample's fields, random content (the TPU
    package's tests/test_packing.py:mk_sample)."""
    ids = lambda n: rng.integers(1, 40, size=n).astype(np.int64)  # noqa: E731
    edges = lambda n, k: [tuple(map(int, rng.integers(0, n, 2))) for _ in range(k)]  # noqa: E731
    return dict(
        vis_fea=rng.standard_normal((no, FEA_DIM)).astype(np.float32),
        macro_ids=ids(nm),
        macro_edges=edges(nm, 2 * nm),
        obj_locs=np.sort(rng.choice(nm, size=min(no, nm), replace=False)).astype(np.int64),
        micro_pos_obj=rng.integers(1, 40, size=(no, TOPN)).astype(np.int64),
        micro_neg_obj=rng.integers(1, 40, size=(no, TOPN)).astype(np.int64),
        q_ids=ids(nq),
        q_edges=edges(nq, nq),
        answer=answer,
    )


def both(groups, shape, n_pack):
    """(JAX batch of jnp arrays, port batch of CPU tensors) of the same
    groups of sample fields."""
    jgroups = [None if g is None else [jax_ds.Sample(**f) for f in g] for g in groups]
    pgroups = [None if g is None else [port_ds.Sample(**f) for f in g] for g in groups]
    jb = jax_packing.collate_packed(jgroups, jax_ds.BatchShape(*shape), TOPN, n_pack, FEA_DIM)
    pb = packing.collate_packed(pgroups, port_ds.BatchShape(*shape), TOPN, n_pack, FEA_DIM)
    return jax.tree.map(jnp.asarray, jb), host_tensors(pb)


def packed_groups(seed=0):
    """Four rows of up to two samples: full, under-full, empty, full."""
    rng = np.random.default_rng(seed)
    s = lambda *a: sample_fields(rng, *a)  # noqa: E731
    return [[s(3, 8, 5, 3), s(4, 9, 6, 1)], [s(2, 6, 4, 2)], None,
            [s(1, 4, 3, 5), s(2, 5, 4, 0)]]


def packed_model_pair(kw=None, groups=None, n_pack=2):
    """The JAX model, its perturbed variables, and the port model holding
    the same weights, with the packed batch on both sides."""
    kw = dict(KW, **(kw or {}))
    jb, pb = both(groups or packed_groups(), SHAPE, n_pack)
    jmodel = JaxModel(JaxConfig(**kw))
    variables = jax.jit(jmodel.init)(jax.random.key(0), jb)
    params, jparams = perturbed(variables["params"])
    constants = jax.device_get(variables.get("constants", {}))
    model = AttModelX3(ModelConfig(**kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, kw["num_blocks"], constants),
                          strict=True)
    return jmodel, {"params": jparams, **({"constants": constants} if constants else {})}, \
        jb, model.eval(), pb


@pytest.fixture(scope="module")
def pair():
    """:func:`packed_model_pair` of the packed model, built once; a test
    that steps the port model builds its own."""
    torch.set_num_threads(1)
    return packed_model_pair()


def port_model(pair):
    """A fresh port model holding the pair's weights."""
    model = AttModelX3(ModelConfig(**KW), device="cpu")
    model.load_state_dict(pair[3].state_dict())
    return model.eval()


def assert_same_batch(jb, pb, what=""):
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(pb, f.name)
        if a is None or b is None:
            assert a is None and b is None, (what, f.name)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f.name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f.name)


# ---- the collate and the row planner --------------------------------------


@pytest.mark.parametrize("n_pack", [2, 4])
def test_collate_packed_equals_jax_value_for_value(n_pack):
    rng = np.random.default_rng(n_pack)
    s = lambda *a: sample_fields(rng, *a)  # noqa: E731
    groups = [[s(3, 8, 5, 3), s(4, 9, 6, 1)], [s(2, 6, 4, 2)], None, []]
    if n_pack == 4:
        groups.append([s(1, 4, 3, 5), s(2, 5, 3, 0), s(2, 4, 3, 1), s(2, 5, 3, 6)])
    jgroups = [None if g is None else [jax_ds.Sample(**f) for f in g] for g in groups]
    pgroups = [None if g is None else [port_ds.Sample(**f) for f in g] for g in groups]
    shape = (8, 20, 12)
    jb = jax_packing.collate_packed(jgroups, jax_ds.BatchShape(*shape), TOPN, n_pack, FEA_DIM)
    pb = packing.collate_packed(pgroups, port_ds.BatchShape(*shape), TOPN, n_pack, FEA_DIM)
    assert_same_batch(jb, pb)
    assert pb.answer.shape == pb.sample_valid.shape == (len(groups), n_pack)
    assert pb.sample_valid.sum() == sum(len(g) for g in groups if g)
    assert (pb.vis_seg[2] == -1).all() and (pb.q_seg[3] == -1).all()
    assert np.array_equal(packing._RAMP, jax_packing._RAMP)


def test_packed_row_fits_like_jax_on_random_samples():
    rng = np.random.default_rng(11)
    shape = (16, 40, 16)
    for n_pack in (2, 3, 4):
        jrow = jax_packing.PackedRow(jax_ds.BatchShape(*shape), n_pack)
        prow = packing.PackedRow(port_ds.BatchShape(*shape), n_pack)
        answers = []
        for _ in range(40):
            f = sample_fields(rng, int(rng.integers(1, 9)), int(rng.integers(2, 20)),
                              int(rng.integers(1, 9)), 0)
            want = jrow.fits(jax_ds.Sample(**f))
            assert prow.fits(port_ds.Sample(**f)) == want
            answers.append(want)
            if want:
                jrow.add(jax_ds.Sample(**f))
                prow.add(port_ds.Sample(**f))
            assert (prow.vis_used, prow.macro_used, prow.q_used, len(prow.samples)) == (
                jrow.vis_used, jrow.macro_used, jrow.q_used, len(jrow.samples))
        assert any(answers) and not all(answers)


# ---- the loader -------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pack_tree"))
    write_fixture(root, n_images=6, n_questions=40, seed=3, n_obj_range=(2, 6))
    return root


def loaders(root, only_obj=True, dirs=None, **kw):
    """The JAX and the port loader of one config; ``dirs`` names cache
    directories, each side getting its own subdirectory."""
    args = dict(data_dir=root, maxlen=128, topn=2, min_cnt=50, only_obj=only_obj,
                pred_rel=True, with_loc=True)
    jds = jax_ds.GQASuperNodeDataset("train", jax_ds.DataConfig(**args))
    pds = port_ds.GQASuperNodeDataset("train", port_ds.DataConfig(**args))
    side = lambda s: {k: f"{v}/{s}" for k, v in (dirs or {}).items()}  # noqa: E731
    return (jax_ds.BatchLoader(jds, 4, num_threads=2, **kw, **side("jax")),
            port_ds.BatchLoader(pds, 4, num_threads=2, **kw, **side("port")))


PACKED_LOADERS = {
    "n_pack2_bucket1": dict(n_pack=2, pack_bucket=1, shuffle=True, seed=5),
    "n_pack4_bucket1": dict(n_pack=4, pack_bucket=1, shuffle=False, drop_last=False),
    "n_pack2_largest": dict(n_pack=2, shuffle=False),
    "tight": dict(tight=True, shuffle=False, drop_last=False),
}


@pytest.mark.parametrize("mode", sorted(PACKED_LOADERS))
def test_packed_loader_equals_jax_batch_for_batch(tree, mode):
    jl, pl = loaders(tree, **PACKED_LOADERS[mode])
    assert (pl.tight, str(pl.pack_bucket)) == (jl.tight, str(jl.pack_bucket)) and pl.tight
    assert pl._batch_fingerprint() == jl._batch_fingerprint()
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jbatches, pbatches = list(jl), list(pl)
        assert len(jbatches) == len(pbatches) > 0
        for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
            assert_same_batch(jb, pb, f"epoch {epoch} batch {i}")
        assert jl.last_dropped == pl.last_dropped
    n_pack = PACKED_LOADERS[mode].get("n_pack", 1)
    assert all(b.sample_valid.shape == (4, n_pack) for b in pbatches)
    if n_pack > 1:   # rows really hold several samples
        assert max(int(r.sum()) for b in pbatches for r in b.sample_valid) > 1


def test_packed_loader_through_the_caches_equals_jax(tree, tmp_path):
    """The batch cache's records are JAX's bytes; batch replay and the
    sample cache give JAX's packed batches."""
    kw = dict(n_pack=2, pack_bucket=1, shuffle=False, drop_last=False)
    jl, pl = loaders(tree, dirs=dict(batch_cache_dir=str(tmp_path / "batches")), **kw)
    first, want = list(pl), list(jl)
    assert pl.replay_cache() is not None
    for i, (a, b, c) in enumerate(zip(list(pl), first, want)):
        assert port_bc._pack_batch(a) == jax_bc._pack_batch(c) == port_bc._pack_batch(b), i
    assert pl.last_dropped == jl.last_dropped

    kw = dict(n_pack=2, pack_bucket=1, shuffle=True, seed=3)
    dirs = dict(batch_replay_dir=str(tmp_path / "replay"), cache_dir=str(tmp_path / "samples"))
    jl, pl = loaders(tree, dirs=dirs, **kw)
    for epoch in (0, 1):            # 0 builds both caches; 1 replays in a new order
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for i, (jb, pb) in enumerate(zip(list(jl), list(pl))):
            assert_same_batch(jb, pb, f"replay epoch {epoch} batch {i}")
    _, fresh = loaders(tree, dirs=dict(cache_dir=str(tmp_path / "samples")), **kw)
    assert fresh.batch_replay_dir is None
    fresh.set_epoch(2)     # from the port's sample cache
    jl2, _ = loaders(tree, **kw)
    jl2.set_epoch(2)
    for i, (jb, pb) in enumerate(zip(list(jl2), list(fresh))):
        assert_same_batch(jb, pb, f"sample cache batch {i}")


def test_packing_needs_only_obj_like_jax(tree):
    for kw in (dict(n_pack=2), dict(tight=True)):
        with pytest.raises(ValueError, match="only_obj"):
            loaders(tree, only_obj=False, **kw)


# ---- the model --------------------------------------------------------------


def test_packed_logits_and_mil_nce_match_jax(pair):
    jmodel, variables, jb, model, pb = pair
    want = jax.jit(jmodel.apply)(variables, jb)
    with torch.no_grad():
        got = model(pb)
    assert got[0].shape == (4, 2, KW["num_classes"])
    for name, w, g in zip(("concat", "vis", "syb", "mil_obj", "mil_rel"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=name)


def _tight_alone(fields, shape):
    """The sample alone, through the tight collate at ``shape``."""
    return host_tensors(packing.collate_packed(
        [[port_ds.Sample(**fields)]], port_ds.BatchShape(*shape), TOPN, 1, FEA_DIM))


def test_each_packed_slot_equals_its_sample_collated_alone(pair):
    """Tight-bucket semantics: a packed slot's logits equal its sample
    collated alone, through the tight collate at the same bucket and through
    the unpacked collate at the sample's own lengths (no padding), within
    1e-5 (the twin of the TPU package's tests/test_packing.py:57)."""
    groups = packed_groups()
    _, _, _, model, pb = pair
    with torch.no_grad():
        packed = model(pb)
        for i, group in enumerate(groups):
            for k, fields in enumerate(group or []):
                own = (fields["vis_fea"].shape[0], len(fields["macro_ids"]),
                       len(fields["q_ids"]))
                plain = host_tensors(port_ds.collate(
                    [port_ds.Sample(**fields)], port_ds.BatchShape(*own), TOPN, FEA_DIM))
                for alone, token in ((_tight_alone(fields, SHAPE), (0, 0)), (plain, (0,))):
                    got = model(alone)
                    for name, p, a in zip(("concat", "vis", "syb"), packed, got):
                        np.testing.assert_allclose(
                            p[i, k].numpy(), a[token].numpy(), atol=SLOT_ATOL, rtol=0,
                            err_msg=f"row {i} slot {k} {name}")


def test_content_swap_leaves_the_other_slot_alone(pair):
    """Changing sample B's content changes B's logits and not A's (the twin
    of the TPU package's tests/test_packing.py:103)."""
    rng = np.random.default_rng(4)
    s1, s2, s2b = (sample_fields(rng, *a) for a in ((3, 8, 5, 3), (4, 9, 6, 1), (4, 9, 6, 2)))
    model = pair[3]
    _, a = both([[s1, s2]], SHAPE, 2)
    _, b = both([[s1, s2b]], SHAPE, 2)
    with torch.no_grad():
        la, lb = model(a), model(b)
    for ga, gb in zip(la[:3], lb[:3]):
        np.testing.assert_allclose(ga[0, 0].numpy(), gb[0, 0].numpy(), atol=SWAP_ATOL, rtol=0)
        assert not np.allclose(ga[0, 1].numpy(), gb[0, 1].numpy(), atol=1e-3)


def test_build_stage_graphs_with_segments_matches_jax():
    from structured_alignment_vqa_tpu.models.att_model_x3 import build_stage_graphs as jax_bsg
    from structured_alignment_vqa_tpu_torch.models.att_model_x3 import build_stage_graphs

    jb, pb = both(packed_groups(), SHAPE, 2)
    for use_dec_mask in (True, False):
        for distinct in (False, True):
            args = dict(use_dec_mask=use_dec_mask, distinct_cross_stage=distinct, n_pack=2)
            want = jax_bsg(jb.macro_mask, jb.q_mask, jb.q_graph, jb.macro_graph,
                           mod_seg=jb.macro_seg, q_seg=jb.q_seg, **args)
            got = build_stage_graphs(pb.macro_mask, pb.q_mask, pb.q_graph, pb.macro_graph,
                                     mod_seg=pb.macro_seg, q_seg=pb.q_seg, **args)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert (got[1] is got[2]) == (not distinct)
    assert got[3].shape == (4, 2, SHAPE[1] + SHAPE[2])


# ---- the steps --------------------------------------------------------------


def _jax_metrics(jmodel, variables, jb):
    lc, lv, ls, _, _ = jmodel.apply(variables, jb)
    _, log_sm = jax_losses.ensemble_smoothed_ce(lc, lv, ls, jb.answer, jb.sample_valid, 0.1)
    return jax_losses.batch_metrics(log_sm, jb.answer, jb.sample_valid)


def assert_grads_match(model, jgrads):
    """Each parameter's gradient within GRAD_RTOL of JAX's, relative to the
    largest |JAX gradient| of that parameter; the shared table once."""
    want = state_dict_from_jax(jax.device_get(jgrads), KW["num_blocks"])
    named = dict(model.named_parameters())
    assert set(named) <= set(want) and set(want) - set(named) < set(GLOVE_SLOTS)
    for name, p in named.items():
        w = want[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
        assert err <= GRAD_RTOL, (name, err)


def test_packed_dense_step_matches_jax(pair):
    """One packed training step: loss and every gradient within 1e-4 of
    jax.grad of the JAX loss; n and n_correct equal JAX's."""
    jmodel, variables, jb, _, pb = pair
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, True)))(
        variables["params"], jb)
    model = port_model(pair)
    opt = adam(model.parameters())
    m = make_train_step(model, opt, model.cfg)(TrainState(model, opt), pb)
    np.testing.assert_allclose(m["loss"].item(), float(jloss), atol=STEP_ATOL, rtol=0)
    want = jax.jit(_jax_metrics, static_argnums=0)(jmodel, variables, jb)
    assert [m["n_correct"].item(), m["n"].item()] == [float(x) for x in want]
    assert m["n"].item() == 5.0          # the five valid pack slots
    assert_grads_match(model, jgrads)


def test_packed_sparse_step_matches_jax_sparse_step(pair):
    """One packed step with the sparse GloVe-table optimizer against the
    TPU package's sparse step: loss, metrics and every parameter after the
    step (the table included) within 1e-4."""
    jmodel, variables, jb, _, pb = pair
    model = port_model(pair)
    lr = 1e-4
    tx = jax_adam(lr)
    # create_train_state reads the params from model.init; hand it a copy of
    # the pair's (the jitted step donates its state)
    inited = type("Inited", (), {"init": lambda self, rng, batch: {
        "params": jax.tree.map(jnp.array, variables["params"])}})()
    jstate = jax_state(inited, None, jb, tx, sparse_table=True)
    jstep = jax_train_step(jmodel, tx, jmodel.cfg, sparse_table=True, table_lr=lr)
    jstate, jm = jstep(jstate, jb, jax.random.key(1))
    state = create_train_state(model, lr, sparse_table=True)
    m = make_train_step(model, state.optimizer, model.cfg, sparse_table=True)(state, pb)
    assert m["skipped"].item() == float(jm["skipped"]) == 0.0
    for key in ("loss", "ce", "mil_nce_loss"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=STEP_ATOL, rtol=0)
    for key in ("n", "n_correct"):
        assert m[key].item() == float(jm[key])
    want = state_dict_from_jax(jax.device_get(jstate.params), KW["num_blocks"])
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=STEP_ATOL, rtol=0,
                                   err_msg=name)
    assert int(state.table_opt.count) == 1


def test_losses_and_metrics_reduce_over_b_k_like_jax():
    """train/losses.py on (B, K) logits with (B, K) answers and validity."""
    from structured_alignment_vqa_tpu_torch.train import losses

    rng = np.random.default_rng(3)
    lc, lv, ls = (rng.standard_normal((4, 3, 7)).astype(np.float32) * 3 for _ in range(3))
    answer = rng.integers(0, 7, size=(4, 3)).astype(np.int32)
    valid = (rng.random((4, 3)) < 0.6).astype(np.int32)
    t = [torch.from_numpy(a) for a in (lc, lv, ls, answer, valid)]
    j = [jnp.asarray(a) for a in (lc, lv, ls, answer, valid)]
    loss, log_sm = losses.ensemble_smoothed_ce(*t)
    want_loss, want_log_sm = jax_losses.ensemble_smoothed_ce(*j)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-6, rtol=0)
    np.testing.assert_allclose(log_sm.numpy(), np.asarray(want_log_sm), atol=1e-6, rtol=0)
    got = [x.item() for x in losses.batch_metrics(log_sm, t[3], t[4])]
    assert got == [float(x) for x in jax_losses.batch_metrics(want_log_sm, j[3], j[4])]
    assert got[1] == valid.sum()


def test_a_packed_batch_with_a_nan_feature_is_skipped(pair):
    """The skip-nonfinite guard on a packed batch: no update, Adam's state
    and the parameters bitwise as they were."""
    model = port_model(pair)
    opt = adam(model.parameters())
    state, step = TrainState(model, opt), make_train_step(model, opt, model.cfg)
    pb = pair[4]
    step(state, pb)
    before = [p.detach().clone() for p in model.parameters()]
    moments = [t.clone() for s in opt.state.values() for t in s.values() if torch.is_tensor(t)]
    vis = pb.vis_fea.clone()
    vis[1, 0, 0] = float("nan")
    m = step(state, dataclasses.replace(pb, vis_fea=vis))
    assert m["skipped"].item() == 1.0 and state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(
        moments, [t for s in opt.state.values() for t in s.values() if torch.is_tensor(t)]))


def test_int8_serving_of_a_packed_batch_matches_jax_int8(pair):
    jmodel, variables, jb, _, pb = pair
    qtree = jax_quant.quantize_params(jax.device_get(variables["params"]))
    jq = JaxModel(JaxConfig(int8_serving=True, **KW))
    want = jax.jit(jq.apply)({"params": qtree}, jb)
    model = AttModelX3(ModelConfig(int8_serving=True, **KW), device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(qtree, KW["num_blocks"]), strict=True)
    with torch.no_grad():
        got = model(pb)
    for name, w, g in zip(("concat", "vis", "syb", "mil_obj"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=name)
    answers = np.asarray(jax_predict_step(jq)(_State(params=qtree, constants={}), jb))
    assert answers.shape == (4, 2)
    np.testing.assert_array_equal(make_predict_step(model)(pb).numpy(), answers)
