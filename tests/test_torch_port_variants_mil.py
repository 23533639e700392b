"""The port's MIL-line ablation variants (x5, x6, x7), the fusion_dec_mil
line, relatt and x3_ori (``models/variants.py``), and the attention-MIL
loss (``train/att_mil_loss.py``), against the JAX package's.

The same random weights (``models/convert_variants.py``, ``strict=True``)
and numpy inputs (``tests/variant_port_cases.py``) on both sides, float32
on the CPU. Logits and losses agree within 1e-4, attention weights within
1e-5, the loss within 1e-5, gradients within 1e-4 of each one's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import variant_port_cases as vc
from structured_alignment_vqa_tpu.models import variants as jax_variants
from structured_alignment_vqa_tpu.train.att_mil_loss import att_mil_loss as jax_att_mil_loss
from structured_alignment_vqa_tpu_torch.models.variants import _last_writer_put
from structured_alignment_vqa_tpu_torch.train.att_mil_loss import att_mil_loss

NAMES = ("x2_fusion_dec_relatt", "x2_fusion_dec_mil", "x2_fusion_dec_mil2", "x3_ori",
         "x5_dec_mil", "x6_dec_mil", "x7_dec_mil")
DEEP = dict(num_blocks=6, stage1_blocks=2, stage2_blocks=4)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _port_out(name, params, args=None, **kw):
    model = vc.port_model(name, params)
    with torch.no_grad():
        return model(*vc.port_args(args or vc.numpy_inputs(name)), **kw)


@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax(name):
    """Every output: logits (all three heads where there are three), the
    attention-weight lists, x3_ori's mil_obj and mil_rel. x3_ori's relation
    rows repeat and go negative (the last writer wins, a negative row wraps
    to the end); x6's -1 object slots wrap to the last row."""
    params, want = vc.jax_case(name)
    assert not vc.unmapped_leaves(name, params)
    got = _port_out(name, params)
    vc.assert_outputs_close(got, want, name)
    if name in ("x5_dec_mil", "x7_dec_mil", "x6_dec_mil", "x2_fusion_dec_mil"):
        n_att = {"x5_dec_mil": 3, "x7_dec_mil": 3, "x6_dec_mil": 1, "x2_fusion_dec_mil": 3}
        assert len(got[-1]) == n_att[name]


@pytest.mark.parametrize("name", NAMES, ids=[
    "X2FusionDecRelatt", "X2FusionDecMil", "X2FusionDecMil2", "X3OriModel", "X5DecMil",
    "X6DecMil", "X7DecMil"])
def test_name_map_covers_both_models(name):
    """At the reference's depth: the map names every port parameter and
    every JAX leaf, shape for shape."""
    vc.name_map_matches(name, **DEEP)


@pytest.mark.parametrize("option", ["visGraph off", "region features + 1"])
def test_relatt_options_change_the_output_alike(option):
    """The vis-symbolic graph switched off, or other region features (the
    substitution must matter): the port follows JAX, and the output moves."""
    name = "x2_fusion_dec_relatt"
    cfg, _ = vc.configs(name)
    params, base = vc.jax_case(name)
    args = list(vc.numpy_inputs(name))
    kw = {}
    if option == "visGraph off":
        kw["vis_graph_enabled"] = False
    else:
        args[0] = args[0] + 1.0
    jmodel = jax_variants.build_variant(name, cfg)
    want = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)},
                        *vc.jax_args(tuple(args)), **kw)
    got = _port_out(name, params, tuple(args), **kw)
    vc.assert_outputs_close(got, want, f"relatt {option}")
    assert not np.allclose(np.asarray(base[0]), got[0].numpy(), atol=1e-3)


def _mil_loss_inputs(rng, blocks=2, b=3, h=2, o=4, ls=6):
    atts = [rng.random((b, h, o, ls)).astype(np.float32) for _ in range(blocks)]
    idx = np.full((b, o), -1, np.int64)
    idx[0, :3] = [0, 2, 4]
    idx[1, :2] = [1, 3]
    idx[2, :4] = [0, 1, 2, 3]
    graph = (rng.random((b, ls, ls)) > 0.5).astype(np.float32)
    return atts, idx, graph


def test_att_mil_loss_matches_jax_and_the_sequential_oracle():
    """The reference's loop (head 0, slot-position rows, unfilled slots each
    adding the margin) through torch's MarginRankingLoss, and JAX's."""
    rng = np.random.default_rng(0)
    atts, idx, graph = _mil_loss_inputs(rng)
    got = att_mil_loss([torch.from_numpy(a) for a in atts], torch.from_numpy(idx),
                       torch.from_numpy(graph)).item()
    want_jax = float(jax_att_mil_loss([jnp.asarray(a) for a in atts],
                                      jnp.asarray(idx, jnp.int32), jnp.asarray(graph)))
    blocks, b, ls = len(atts), graph.shape[0], graph.shape[1]
    pos_ws, neg_ws = torch.zeros(blocks * b * ls), torch.zeros(blocks * b * ls)
    slot = 0
    for att in atts:
        for i in range(b):
            for k in range(idx.shape[1]):
                if idx[i, k] < 0:
                    continue
                row, nb = att[i, 0, k], graph[i, idx[i, k]]
                pos_ws[slot], neg_ws[slot] = float(row[nb > 0].sum()), float(row[nb == 0].sum())
                slot += 1
    oracle = torch.nn.MarginRankingLoss(0.6)(pos_ws, neg_ws, torch.ones(blocks * b * ls)).item()
    assert abs(got - want_jax) <= 1e-5 and abs(got - oracle) <= 1e-5, (got, want_jax, oracle)


def test_x5_gradients_match_jax_grad():
    """The eval's label-smoothed CE plus the attention-MIL loss on x5's
    alignment weights (sum_eps attention returning its weights): every
    gradient against jax.grad's."""
    name = "x5_dec_mil"
    cfg, _ = vc.configs(name)
    params, _ = vc.jax_case(name)
    args = vc.numpy_inputs(name)
    answer = np.array([3, 7])
    idx = np.array([[0, 2, -1], [1, 3, 5]], np.int64)
    syb_graph = args[7]

    def jax_loss(p):
        logits, atts = jax_variants.build_variant(name, cfg).apply(
            {"params": p}, *vc.jax_args(args))
        return vc.smoothed_ce(logits, answer, jnp) + jax_att_mil_loss(
            [a[:, :, :vc.LV, vc.LV:] for a in atts], jnp.asarray(idx, jnp.int32),
            jnp.asarray(syb_graph))

    jgrads = jax.jit(jax.grad(jax_loss))(jax.tree.map(jnp.asarray, params))
    model = vc.port_model(name, params)
    logits, atts = model(*vc.port_args(args))
    loss = vc.smoothed_ce(logits, answer, torch) + att_mil_loss(
        [a[:, :, :vc.LV, vc.LV:] for a in atts], torch.from_numpy(idx),
        torch.from_numpy(syb_graph))
    loss.backward()
    vc.assert_grads_match(name, model, jax.device_get(jgrads))


def test_last_writer_put_is_the_ordered_loop():
    """Duplicate rows (the last write wins), rows outside the sequence
    (dropped), against the writes made one by one."""
    rng = np.random.default_rng(2)
    dest = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32))
    rows = torch.tensor([[1, 3, 3, 6, 1, 0], [7, -1, 2, 2, 2, 5], [4, 4, 4, 4, 4, 4]])
    values = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
    want = dest.clone()
    for b in range(3):
        for k in range(6):
            if 0 <= rows[b, k] < 7:
                want[b, rows[b, k]] = values[b, k]
    assert torch.equal(_last_writer_put(dest, rows, values), want)


def test_x3_ori_all_pad_pair_has_a_zero_relation_gradient():
    """A pair whose relation candidates are all PAD adds 0 to mil_rel, as in
    JAX, and a zero gradient where JAX's where-of-log gives NaN: every
    gradient of mil_rel is finite and the bilinear form gets one."""
    name = "x3_ori"
    params, want = vc.jax_case(name)
    args = vc.numpy_inputs(name)
    assert (args[13][0, 3] == vc.PAD_ID).all()
    model = vc.port_model(name, params)
    mil_rel = model(*vc.port_args(args))[4]
    assert abs(mil_rel.item() - float(want[4])) <= vc.LOGIT_TOL
    mil_rel.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert model.MIL_NCE.bilinear["weight"].grad.abs().sum() > 0
