"""The port's ``train()`` against the TPU package's ``train()`` on one tiny
fixture tree: 1 epoch, dropout 0, float32 on the CPU. The test patches both
initial states to the same perturbed params (numpy noise on the JAX init,
carried to the port by ``models/convert.py``); nothing in either package
changes. The ``Avg Loss`` series (logged every step) agree within 1e-4, the
val and train accuracies are equal; the same with ``--n_pack 2
--pack_bucket 1`` (packed training, val through the tight collate), whose
epoch line must count valid samples, not rows.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import structured_alignment_vqa_tpu.train.loop as jax_loop
from structured_alignment_vqa_tpu.train import main as jax_main
from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.models import AttModelX3
from structured_alignment_vqa_tpu_torch.models.convert import state_dict_from_jax
from structured_alignment_vqa_tpu_torch.train import loop
from structured_alignment_vqa_tpu_torch.train import main as port_main

LOSS_ATOL = 1e-4


def _series(out, name):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(m.get("step"), m["value"]) for m in map(json.loads, f) if m["name"] == name]


def run_both_trainers(tmp_path, monkeypatch, extra=()):
    """The TPU package's and the port's training CLIs, 1 epoch each from the
    same perturbed params, with ``extra`` flags on both. Returns the tree,
    both output directories and ``assert_agree()``, which holds the two
    runs' Avg Loss series and accuracies against each other."""
    torch.set_num_threads(1)
    root = str(tmp_path / "data")
    write_fixture(root, n_images=8, n_questions=32, seed=1)

    def args(out):
        return ["--data_dir_azure", root, "--output_dir", out, "--model_v", "3",
                "--only_obj", "--with_loc", "--decMask", "--with_MILNCE_loss", "--pred_rel",
                "--batch_size", "4", "--maxlen", "128", "--maxlen_q", "12", "--maxlen_v", "8",
                "--hidden_size", "16", "--hidden_size_mil", "8", "--num_blocks", "3",
                "--num_heads", "2", "--num_epochs", "1", "--min_cnt", "50", "--topN", "2",
                "--log_steps", "1", "--log_steps_val", "100", "--vocab_size", "401000",
                "--glove_dim", "8", "--num_workers", "2", "--dropout_rate", "0.0",
                "--lr", "1e-3", "--share_glove", "--platform", "cpu", *extra]

    noisy = {}
    create = jax_loop.create_train_state

    def perturbed_state(*a, **kw):
        state = create(*a, **kw)
        rng = np.random.default_rng(5)
        noisy["params"] = jax.tree.map(
            lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape)).astype(np.float32),
            jax.device_get(state.params))
        return state.replace(params=jax.tree.map(jnp.asarray, noisy["params"]))

    monkeypatch.setattr(jax_loop, "create_train_state", perturbed_state)
    jax_out = str(tmp_path / "jax")
    jax_main.main(args(jax_out))

    def same_weights(model_cfg, seed, device):
        model = AttModelX3(model_cfg, device=device)
        model.load_state_dict(state_dict_from_jax(noisy["params"], model_cfg.num_blocks),
                              strict=True)
        return model

    monkeypatch.setattr(loop, "new_model", same_weights)
    port_out = str(tmp_path / "port")
    port_main.main(args(port_out))

    def assert_agree():
        want, got = _series(jax_out, "Avg Loss"), _series(port_out, "Avg Loss")
        assert len(want) == len(got) >= 3
        assert [s for s, _ in want] == [s for s, _ in got]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   atol=LOSS_ATOL, rtol=0)
        for name in ("Test Acc", "Train Acc"):
            assert _series(port_out, name) == _series(jax_out, name), name
            assert len(_series(port_out, name)) == 1
        return len(got)

    return dict(root=root, jax_out=jax_out, port_out=port_out, assert_agree=assert_agree,
                port_args=args(port_out))


def test_port_train_agrees_with_jax_train(tmp_path, monkeypatch):
    assert run_both_trainers(tmp_path, monkeypatch)["assert_agree"]() >= 6


@pytest.fixture(scope="module")
def packed_runs(tmp_path_factory):
    """Both training CLIs with --n_pack 2 --pack_bucket 1."""
    with pytest.MonkeyPatch.context() as mp:
        return run_both_trainers(tmp_path_factory.mktemp("packed_train"), mp,
                                 ["--n_pack", "2", "--pack_bucket", "1"])


def test_packed_train_agrees_with_jax_train(packed_runs):
    packed_runs["assert_agree"]()


def test_packed_epoch_logs_valid_samples_per_second(packed_runs):
    """The epoch line's samples/s is the epoch's valid samples over its
    seconds; on packed rows that is not the row count."""
    with open(os.path.join(packed_runs["port_out"], "training.log")) as f:
        line = [x for x in f if "trained" in x][-1]
    steps, seconds, rate = re.search(
        r"trained (\d+) steps in ([\d.]+) s: [\d.]+ steps/s, ([\d.]+) samples/s", line).groups()
    _, train_dc, _, tc = port_main.configs_from_args(
        port_main.build_parser().parse_args(packed_runs["port_args"]))
    batches = list(BatchLoader(GQASuperNodeDataset("train", train_dc), tc.batch_size,
                               shuffle=True, seed=tc.seed, n_pack=tc.n_pack,
                               pack_bucket=tc.pack_bucket))
    valid = sum(int(b.sample_valid.sum()) for b in batches)
    rows = sum(b.sample_valid.shape[0] for b in batches)
    assert int(steps) == len(batches) and valid > rows
    # the line rounds the seconds to 1 ms and the rate to 0.1
    seconds = float(seconds)
    lo, hi = valid / (seconds + 5e-4), valid / max(seconds - 5e-4, 1e-9)
    assert lo - 0.05 <= float(rate) <= hi + 0.05, (rate, valid, seconds)
