"""``--batch_replay`` keys its frozen batches by the shuffle seed.

The batch cache's fingerprint (``data/batch_cache.py:loader_fingerprint``,
equal to the TPU package's) leaves the seed out, yet the seed draws the
first epoch's order and so which samples share a batch. The port's
training CLI roots each seed's replay under ``<cache_dir>/train_batches/
seed<N>`` (``train/loop.py:replay_root``): a second ``--seed`` under one
``--cache_dir`` builds its own batches, and they are, record for record,
the JAX loader's first epoch for that seed.
"""

import dataclasses
import os

import pytest
import torch

from structured_alignment_vqa_tpu.data import batch_cache as jax_bc
from structured_alignment_vqa_tpu.data import dataset as jax_ds
from structured_alignment_vqa_tpu_torch.data import batch_cache as port_bc
from structured_alignment_vqa_tpu_torch.data import dataset as port_ds
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture
from structured_alignment_vqa_tpu_torch.train import loop
from structured_alignment_vqa_tpu_torch.train import main as train_main

SEEDS = (7, 11)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def tiny_args(root, out, cache, seed):
    """tests/test_torch_port_train_driver.py's tiny flags, one epoch."""
    return [
        "--data_dir_azure", root, "--output_dir", out, "--model_v", "3",
        "--only_obj", "--with_loc", "--decMask", "--with_MILNCE_loss",
        "--pred_rel", "--batch_size", "4", "--maxlen", "128", "--maxlen_q", "12",
        "--maxlen_v", "8", "--hidden_size", "16", "--hidden_size_mil", "8",
        "--num_blocks", "2", "--num_heads", "2", "--min_cnt", "50", "--topN", "2",
        "--log_steps", "100", "--log_steps_val", "100", "--vocab_size", "401000",
        "--glove_dim", "8", "--num_workers", "2", "--seed", str(seed),
        "--share_glove", "--platform", "cpu", "--num_epochs", "1", "--no_resume",
        "--cache_dir", cache, "--batch_replay",
    ]


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    """Two CLI runs, seeds 7 then 11, under one cache directory:
    (args of each seed, the cache directory)."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("replay")
    root = str(tmp / "data")
    write_fixture(root, n_images=8, n_questions=32, seed=1)
    cache = str(tmp / "cache")
    args = {}
    for seed in SEEDS:
        args[seed] = tiny_args(root, str(tmp / f"run{seed}"), cache, seed)
        train_main.main(args[seed])
    return args, cache


def frozen_and_jax(args):
    """The frozen batches the port's run published (build order) and the
    JAX loader's first epoch at the run's seed and data config."""
    _, train_dc, _, tc = train_main.configs_from_args(train_main.build_parser().parse_args(args))
    replay = loop.replay_root(tc.cache_dir, tc.seed)
    port = port_ds.BatchLoader(port_ds.GQASuperNodeDataset("train", train_dc), tc.batch_size,
                               shuffle=True, seed=tc.seed, batch_replay_dir=replay)
    cache = port.replay_cache()
    assert cache is not None, replay
    jax_dc = jax_ds.DataConfig(**dataclasses.asdict(train_dc))
    jax = jax_ds.BatchLoader(jax_ds.GQASuperNodeDataset("train", jax_dc), tc.batch_size,
                             shuffle=True, seed=tc.seed)
    jax.set_epoch(0)
    return [cache.batch(i) for i in range(len(cache))], list(jax)


@pytest.mark.parametrize("seed", SEEDS)
def test_each_seed_replays_the_jax_loaders_batches_for_that_seed(replayed, seed):
    args, cache = replayed
    assert sorted(os.listdir(f"{cache}/train_batches")) == sorted(f"seed{s}" for s in SEEDS)
    frozen, jax = frozen_and_jax(args[seed])
    assert len(frozen) == len(jax) > 1
    for i, (a, b) in enumerate(zip(frozen, jax)):
        assert port_bc._pack_batch(a) == jax_bc._pack_batch(b), (seed, i)


def test_the_two_seeds_froze_other_batches(replayed):
    """Which samples share a batch follows the seed: the second run did not
    replay the first run's batches."""
    args, _ = replayed
    (a, _), (b, _) = (frozen_and_jax(args[s]) for s in SEEDS)
    assert [port_bc._pack_batch(x) for x in a] != [port_bc._pack_batch(x) for x in b]
