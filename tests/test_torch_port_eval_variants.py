"""The port's variant eval CLI (``train/evaluate_variants.py``) against the
JAX package's on one fixture tree.

For the 5 cases of ``tests/test_eval_variants.py`` (x and x2 of the
max-pool family, x2_dec of the dec family, x5_dec_mil and x6_dec_mil of the
MIL family on the ``itp_bbox_q`` loader): JAX's ``eval_batches`` on JAX's
batches with random params (numpy-drawn, ``tests/variant_port_cases.py``),
against the port's ``eval_batches`` on the port's batches with the same
params carried by ``models/convert_variants.py``, and against the port's
``main`` on the CPU reading them from a checkpoint (``--weight_dir``):
the loss within 1e-5 relative, the correct and valid counts equal. Also:
reading the device sums once at the end gives the loss of reading them
every batch, and the five variants the JAX CLI cannot call fail in the
port's CLI as in JAX's. float32, dropout 0, one thread.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.data import node_graph_dataset as jax_ng
from structured_alignment_vqa_tpu.data.fixtures import write_fixture
from structured_alignment_vqa_tpu.models.config import ModelConfig as JaxConfig
from structured_alignment_vqa_tpu.models.variants import build_variant as jax_build
from structured_alignment_vqa_tpu.train import evaluate_variants as jax_ev
from structured_alignment_vqa_tpu_torch.models.convert_variants import (
    variant_state_dict_from_jax,
)
from structured_alignment_vqa_tpu_torch.models.variants import build_variant as port_build
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, adam
from structured_alignment_vqa_tpu_torch.train import evaluate_variants as port_ev
from structured_alignment_vqa_tpu_torch.utils.checkpoint import save_checkpoint
from variant_port_cases import random_params

LOSS_RTOL = 1e-5
CASES = (
    ("x", ["--model_v", "1"]),
    ("x2", ["--model_v", "2"]),
    ("x2_dec", ["--model_v", "2", "--with_dec"]),
    ("x5_dec_mil", ["--variant", "x5_dec_mil", "--loader", "itp_bbox_q"]),
    ("x6_dec_mil", ["--variant", "x6_dec_mil", "--loader", "itp_bbox_q"]),
)
FLAGS = ["--split", "train", "--q_tar_fn", "train.tar", "--batch_size", "4",
         "--maxlen", "64", "--maxlen_q", "12", "--maxlen_v", "6", "--hidden_size", "16",
         "--num_blocks", "2", "--num_heads", "2", "--min_cnt", "50",
         "--vocab_size", "401000", "--glove_dim", "8", "--log_steps", "2"]
LOGGER = logging.getLogger("test_torch_port_eval_variants")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ev_port_fixture"))
    write_fixture(root, n_images=6, n_questions=16, seed=5)
    return root


def parse(fixture_dir, extra, *more):
    return port_ev.build_parser().parse_args(["--data_dir_azure", fixture_dir, "--loader",
                                              "itp_gt", *extra, *FLAGS, *more])


def jax_init_args(variant, family, b0):
    """The JAX CLI's init arguments for ``variant`` on its first batch."""
    vis = jnp.asarray(b0["vis_fea"])
    q, qm, qg = (jnp.asarray(b0["q_ipt"], jnp.int32), jnp.asarray(b0["q_mask"]),
                 jnp.asarray(b0["q_graph"]))
    node, nm, ng = (jnp.asarray(b0["node_ipt"], jnp.int32), jnp.asarray(b0["node_mask"]),
                    jnp.asarray(b0["node_graph"]))
    ones = jnp.ones(vis.shape[:2], jnp.float32)
    if family == "dec":
        sq = jax_ev._square
        return vis, sq(ones), q, sq(qm), qg, node, sq(nm), ng
    if family == "mil":
        idx = (jnp.asarray(b0["idx_of_obj"], jnp.int32),) if variant == "x6_dec_mil" else ()
        return (vis, ones, q, qm, qg, node, nm, ng, *idx)
    return vis, q, qm, qg, node, nm, ng


def jax_side(args, variant):
    """JAX's dataset, batches, random params and ``eval_batches`` result."""
    dcfg = jax_ng.config_for_variant(args.loader, args.data_dir_azure, q_tar=args.q_tar_fn,
                                     maxlen=args.maxlen, min_cnt=args.min_cnt)
    ds = jax_ng.NodeGraphDataset(args.split, dcfg)
    kw = vars(port_ev.model_config(args, ds))
    kw.pop("compute_dtype")
    model = jax_build(variant, JaxConfig(**kw))
    batches = _jax_batches(ds, args)
    family = port_ev.family_of(variant)
    params = random_params(model, jax_init_args(variant, family, batches[0]), {})
    result = jax_ev.eval_batches(model, {"params": jax.tree.map(jnp.asarray, params)}, batches,
                                 LOGGER, args.log_steps, family=family)
    return params, batches, result


def _jax_batches(ds, args):
    lv, ls, lq = args.maxlen_v, args.maxlen - args.maxlen_q, args.maxlen_q
    samples = [ds.sample(i) for i in range(len(ds))]
    samples += [None] * (-len(samples) % args.batch_size)
    return [jax_ng.collate_node_graph(samples[i:i + args.batch_size], lv, ls, lq)
            for i in range(0, len(samples), args.batch_size)]


def port_model(args, variant, params):
    ds = port_ev.NodeGraphDataset(args.split, port_ev.config_for_variant(
        args.loader, args.data_dir_azure, q_tar=args.q_tar_fn, maxlen=args.maxlen,
        min_cnt=args.min_cnt))
    cfg = port_ev.model_config(args, ds)
    model = port_build(variant, cfg, device="cpu")
    model.load_state_dict(variant_state_dict_from_jax(variant, params, cfg), strict=True)
    return ds, model


def assert_same_result(got, want):
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (got, want)
    assert got[1:] == want[1:], (got, want)


@pytest.fixture(scope="module")
def cases(fixture_dir):
    """Each case's JAX result, port batches, port model and parsed flags."""
    out = {}
    for variant, extra in CASES:
        args = parse(fixture_dir, extra)
        assert port_ev.variant_from_args(args) == variant
        params, jax_batches, want = jax_side(args, variant)
        ds, model = port_model(args, variant, params)
        out[variant] = dict(args=args, extra=extra, params=params, want=want, model=model,
                            batches=port_ev.load_batches(ds, args), jax_batches=jax_batches)
    return out


@pytest.mark.parametrize("variant", [c[0] for c in CASES])
def test_eval_batches_equals_jax(cases, variant):
    c = cases[variant]
    for a, b in zip(c["batches"], c["jax_batches"], strict=True):
        assert all(np.array_equal(a[k], b[k]) for k in b)
    got = port_ev.eval_batches(c["model"], c["batches"], LOGGER, c["args"].log_steps,
                               family=port_ev.family_of(variant), device="cpu")
    assert_same_result(got, c["want"])
    assert c["want"][2] > 0 and np.isfinite(got[0])


@pytest.mark.parametrize("variant", [c[0] for c in CASES])
def test_main_on_the_cpu_equals_jax(cases, variant, tmp_path):
    """``main`` with the JAX params in a port checkpoint: JAX's loss and
    accuracy, finite, in [0, 1]."""
    c = cases[variant]
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, TrainState(c["model"], adam(c["model"].parameters())), epoch=1)
    loss, acc = port_ev.main(["--data_dir_azure", c["args"].data_dir_azure,
                              "--loader", "itp_gt", *c["extra"], *FLAGS,
                              "--output_dir", str(tmp_path / "out"), "--weight_dir", ckpt,
                              "--platform", "cpu"])
    want_loss, corr, n = c["want"]
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    assert acc == corr / max(n, 1)
    log = (tmp_path / "out" / "training.log").read_text()
    assert f"Eval[{variant}/train] Loss: {loss}" in log and "samples/s" in log


def test_one_read_at_the_end_equals_a_read_every_batch(cases):
    c = cases["x2_dec"]
    family = port_ev.family_of("x2_dec")
    every = port_ev.eval_batches(c["model"], c["batches"], LOGGER, 1, family=family,
                                 device="cpu")
    once = port_ev.eval_batches(c["model"], c["batches"], LOGGER, 10 ** 6, family=family,
                                device="cpu")
    assert len(c["batches"]) >= 3
    assert abs(once[0] - every[0]) <= 1e-6 * abs(every[0]) and once[1:] == every[1:]


@pytest.mark.parametrize("variant", ["x2_fusion_dec_relatt", "x2_fusion_dec_mil",
                                     "x2_fusion_dec_mil2", "x3_ori", "x4_dec"])
def test_variants_the_jax_cli_cannot_call_fail_alike(fixture_dir, tmp_path, variant):
    """The JAX CLI calls these five with its family's inputs, which they
    do not take (x4_dec falls to the max-pool form, one argument short):
    both CLIs raise a TypeError."""
    argv = ["--data_dir_azure", fixture_dir, "--loader", "itp_gt", "--variant", variant,
            *FLAGS, "--output_dir", str(tmp_path / "out")]
    with pytest.raises(TypeError):
        jax_ev.main(argv)
    with pytest.raises(TypeError):
        port_ev.main(argv + ["--platform", "cpu"])
