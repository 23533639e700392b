"""The port's node-graph loader family (``data/node_graph_dataset.py``)
against the JAX package's, sample for sample, on one fixture tree.

Counterparts of the 7 tests of ``tests/test_node_graph_data.py``: every
preset of ``config_for_variant`` (11) gives the same samples as JAX's
(``vis_fea``, ``node_ids``, ``edges``, ``q_ids``, ``q_edges``, ``answer``,
``idx_of_obj`` and the visrel arrays), with the three reference quirks on
and off and the label-noise augmentation at rate 0 and 1 (the per-sample
generator draws the same labels), and ``collate_node_graph`` gives the same
arrays. Pure numpy on both sides: equal means bitwise.
"""

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.data import node_graph_dataset as jax_ng
from structured_alignment_vqa_tpu.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.data import node_graph_dataset as port_ng

PRESETS = (
    "itp", "itp_gt", "itp_gt_loc", "itp_gt_bbox", "itp_gt_bbox_gtrel", "itp_gtWpred_bbox",
    "itp_GTRelPredNode_bbox", "itp_GTRelPredNode_bbox_freq", "itp_bbox_q", "itp_bbox_aug",
    "itp_bbox_visrel",
)
# each quirk flag off, on the preset whose node source it changes
FIXED_QUIRKS = (
    ("itp_gt", dict(gt_off_by_one=False)),
    ("itp_gt_loc", dict(center_grid_floor_bug=False)),
    ("itp_gt_loc", dict(gt_off_by_one=False, center_grid_floor_bug=False)),
    ("itp", dict(detected_stale_bbox=False)),
)
LV, LS, LQ = 6, 48, 12
ARRAY_FIELDS = ("vis_fea", "node_ids", "q_ids", "idx_of_obj", "vis_node_ids", "syb2vis",
                "valid2all")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ng_port_fixture"))
    write_fixture(root, n_images=8, n_questions=24, seed=3)
    return root


def datasets(fixture_dir, variant, **kw):
    """The JAX and the port dataset of ``variant`` on the fixture tree."""
    args = dict(q_tar="train.tar", maxlen=200, topn=2, min_cnt=50, **kw)
    return (jax_ng.NodeGraphDataset("train", jax_ng.config_for_variant(variant, fixture_dir,
                                                                       **args)),
            port_ng.NodeGraphDataset("train", port_ng.config_for_variant(variant, fixture_dir,
                                                                         **args)))


def assert_same_sample(a, b, where):
    assert (a is None) == (b is None), where
    if a is None:
        return
    for name in ARRAY_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), (where, name)
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), (where, name)
    for name in ("edges", "vis_edges"):
        x, y = getattr(a, name), getattr(b, name)
        assert (None if x is None else [tuple(e) for e in x]) == \
            (None if y is None else [tuple(e) for e in y]), (where, name)
    assert [list(e) for e in a.q_edges] == [list(e) for e in b.q_edges], where
    assert a.answer == b.answer, where


def differs(a, b) -> bool:
    return a is not None and b is not None and (
        a.edges != b.edges or not np.array_equal(a.node_ids, b.node_ids))


def assert_same_samples(jds, pds, variant):
    assert len(jds) == len(pds)
    kept = 0
    for i in range(len(jds)):
        a, b = jds.sample(i), pds.sample(i)
        assert_same_sample(a, b, (variant, i))
        kept += a is not None
    return kept


@pytest.mark.parametrize("variant", PRESETS)
def test_every_preset_gives_jax_samples(fixture_dir, variant):
    jds, pds = datasets(fixture_dir, variant)
    assert port_ng.config_for_variant(variant, fixture_dir) == \
        port_ng.NodeGraphConfig(**vars(jax_ng.config_for_variant(variant, fixture_dir)))
    kept = assert_same_samples(jds, pds, variant)
    assert kept >= len(jds) // 2, f"{variant}: only {kept}/{len(jds)} samples"


@pytest.mark.parametrize("variant,flags", FIXED_QUIRKS,
                         ids=[f"{v}-{'-'.join(f)}" for v, f in FIXED_QUIRKS])
def test_quirk_flags_off_give_jax_samples(fixture_dir, variant, flags):
    jds, pds = datasets(fixture_dir, variant, **flags)
    assert_same_samples(jds, pds, (variant, flags))
    # the flag changes something on this tree, so the comparison sees it
    _, quirky = datasets(fixture_dir, variant)
    assert any(differs(pds.sample(i), quirky.sample(i)) for i in range(len(pds))), flags


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_label_noise_draws_jax_labels(fixture_dir, rate):
    jds, pds = datasets(fixture_dir, "itp_bbox_aug", label_noise_rate=rate)
    assert_same_samples(jds, pds, rate)
    if rate:
        _, clean = datasets(fixture_dir, "itp_bbox_aug", label_noise_rate=0.0)
        assert any(differs(pds.sample(i), clean.sample(i)) for i in range(len(pds)))


def test_visrel_background_nodes_as_jax(fixture_dir):
    """Out-of-range detections become __background__ nodes connected to all."""
    jds, pds = datasets(fixture_dir, "itp_bbox_visrel")
    data_info = {"objects_id": [[999], [0], [1]], "attrs_id": [0, 1, 0]}
    bbox = np.array([[1, 2, 3, 4]] * 3, np.int32)
    got = pds._nodes_visrel(data_info, bbox)
    assert got == jds._nodes_visrel(data_info, bbox)
    nodes, edges, _, valid2all = got
    assert nodes[0] == "__background__" and valid2all == [1, 2]
    assert [0, 1] in edges and [2, 0] in edges


@pytest.mark.parametrize("variant", ["itp_gt", "itp_bbox_q", "itp_bbox_visrel"])
def test_collate_gives_jax_arrays(fixture_dir, variant):
    jds, pds = datasets(fixture_dir, variant)
    # a None sample and a short batch's padding rows, as the eval CLI makes them
    idx = [0, 1, 2, 3, 4, 5]
    js = [jds.sample(i) for i in idx] + [None, None]
    ps = [pds.sample(i) for i in idx] + [None, None]
    want = jax_ng.collate_node_graph(js, LV, LS, LQ)
    got = port_ng.collate_node_graph(ps, LV, LS, LQ)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["sample_valid"].sum() >= 3
    if variant != "itp_gt":
        assert (got["idx_of_obj"][got["sample_valid"] == 1][:, 0] >= 0).all()
