"""The port's sample cache and batch cache against the TPU package's loader.

Each cache round-trips its records; a loader's second pass, served from the
cache, equals its first and equals the TPU package's loader value for value;
a changed config invalidates the cache; an interrupted pass publishes
nothing. Obj-only and obj+rel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.data import batch_cache as jax_bc
from structured_alignment_vqa_tpu.data import dataset as jax_ds
from structured_alignment_vqa_tpu.data import sample_cache as jax_sc
from structured_alignment_vqa_tpu_torch.data import batch_cache as port_bc
from structured_alignment_vqa_tpu_torch.data import dataset as port_ds
from structured_alignment_vqa_tpu_torch.data import sample_cache as port_sc
from structured_alignment_vqa_tpu_torch.data.fixtures import write_fixture

KINDS = {
    "obj": dict(maxlen=128, topn=2, min_cnt=50, only_obj=True, pred_rel=True, with_loc=True),
    "objrel": dict(maxlen=256, topn=2, min_cnt=50, only_obj=False, pred_rel=True,
                   with_loc=True),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cache_tree"))
    write_fixture(d, n_images=5, n_questions=24, seed=4, n_obj_range=(2, 5))
    return d


def datasets(root, kind, **kw):
    args = dict(KINDS[kind], data_dir=root, **kw)
    return (jax_ds.GQASuperNodeDataset("train", jax_ds.DataConfig(**args)),
            port_ds.GQASuperNodeDataset("train", port_ds.DataConfig(**args)))


def assert_same_batches(a, b):
    assert len(a) == len(b) > 0
    for i, (x, y) in enumerate(zip(a, b)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if u is None or v is None:
                assert u is None and v is None, (i, f.name)
                continue
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and np.array_equal(u, v), (i, f.name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_record_round_trips_and_matches_the_jax_format(root, kind):
    _, pds = datasets(root, kind)
    n = 0
    for i in range(len(pds)):
        s = pds.sample(i)
        if s is None:
            continue
        rec = port_sc.pack_sample(s)
        assert rec == jax_sc.pack_sample(s)
        back = port_sc.unpack_sample(rec)
        for f in dataclasses.fields(s):
            want = getattr(s, f.name)
            if f.name in ("macro_edges", "q_edges"):
                want = np.asarray(want, np.int64).reshape(-1, 2)
            if want is None:
                assert getattr(back, f.name) is None
            else:
                assert np.array_equal(np.asarray(getattr(back, f.name)), np.asarray(want))
        n += 1
    assert n > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_cache_second_pass_equals_first_and_jax(root, kind, tmp_path):
    jds, pds = datasets(root, kind)
    cache = str(tmp_path / "samples")
    loader = port_ds.BatchLoader(pds, 4, shuffle=True, seed=9, drop_last=False,
                                 num_threads=2, cache_dir=cache)
    first = list(loader)
    assert port_sc.valid_cache(cache, pds.split, pds.cfg) is not None
    second = list(loader)
    want = list(jax_ds.BatchLoader(jds, 4, shuffle=True, seed=9, drop_last=False,
                                   num_threads=2))
    assert_same_batches(first, second)
    assert_same_batches(second, want)


def test_sample_cache_is_invalidated_by_a_changed_config(root, tmp_path):
    _, pds = datasets(root, "obj")
    cache = str(tmp_path / "samples")
    list(port_ds.BatchLoader(pds, 4, shuffle=False, num_threads=2, cache_dir=cache))
    assert port_sc.valid_cache(cache, pds.split, pds.cfg) is not None
    with pytest.warns(UserWarning, match="different"):
        assert port_sc.valid_cache(cache, pds.split, dataclasses.replace(pds.cfg, seed=1)) is None
    # the split is fingerprinted too
    with pytest.warns(UserWarning, match="different"):
        assert port_sc.valid_cache(cache, "val", pds.cfg) is None
    # a performance knob alone does not
    assert port_sc.valid_cache(
        cache, pds.split, dataclasses.replace(pds.cfg, image_cache_size=3)) is not None


def test_interrupted_sample_cache_pass_publishes_nothing(root, tmp_path):
    _, pds = datasets(root, "obj")
    cache = str(tmp_path / "samples")
    it = iter(port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False, num_threads=2,
                                  cache_dir=cache))
    next(it)
    it.close()
    assert port_sc.valid_cache(cache, pds.split, pds.cfg) is None


def test_batch_record_round_trips_and_matches_the_jax_format(root):
    _, pds = datasets(root, "objrel")
    b = next(iter(port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False)))
    rec = port_bc._pack_batch(b)
    assert rec == jax_bc._pack_batch(b)
    assert_same_batches([b], [port_bc._unpack_batch(rec, 0)])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batch_cache_second_pass_equals_first_and_jax(root, kind, tmp_path):
    jds, pds = datasets(root, kind)
    cache = str(tmp_path / "batches")
    loader = port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False, num_threads=2,
                                 batch_cache_dir=cache)
    first = list(loader)
    assert loader.replay_cache() is not None
    second = list(loader)
    # the cache's views are writable (copy-on-write), so torch takes them as they are
    assert all(b.vis_fea.flags.writeable for b in second)
    want = list(jax_ds.BatchLoader(jds, 4, shuffle=False, drop_last=False, num_threads=2))
    assert_same_batches(first, second)
    assert_same_batches(second, want)
    assert loader.last_dropped == sum(1 for i in range(len(pds)) if pds.sample(i) is None)


def test_batch_cache_is_invalidated_by_a_changed_config(root, tmp_path):
    _, pds = datasets(root, "obj")
    cache = str(tmp_path / "batches")
    list(port_ds.BatchLoader(pds, 4, shuffle=False, batch_cache_dir=cache))
    assert port_ds.BatchLoader(pds, 4, shuffle=False, batch_cache_dir=cache).replay_cache()
    for other in (port_ds.BatchLoader(pds, 3, shuffle=False, batch_cache_dir=cache),
                  port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False,
                                      batch_cache_dir=cache)):
        with pytest.warns(UserWarning, match="different"):
            assert other.replay_cache() is None
    with pytest.raises(ValueError, match="shuffle=False"):
        port_ds.BatchLoader(pds, 4, shuffle=True, batch_cache_dir=cache)


def test_interrupted_batch_cache_pass_publishes_nothing(root, tmp_path):
    _, pds = datasets(root, "obj")
    cache = str(tmp_path / "batches")
    loader = port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False, num_threads=2,
                                 batch_cache_dir=cache)
    it = iter(loader)
    next(it)
    it.close()
    assert loader.replay_cache() is None
    list(loader)
    assert loader.replay_cache() is not None


def test_batch_replay_equals_jax_epoch_by_epoch(root, tmp_path):
    jds, pds = datasets(root, "obj")
    jl = jax_ds.BatchLoader(jds, 4, shuffle=True, seed=3, num_threads=2,
                            batch_replay_dir=str(tmp_path / "jax"))
    pl = port_ds.BatchLoader(pds, 4, shuffle=True, seed=3, num_threads=2,
                             batch_replay_dir=str(tmp_path / "port"))
    for epoch in (0, 1, 2):         # epoch 0 builds; 1 and 2 replay in a new order
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert_same_batches(list(jl), list(pl))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", [2, 3])
def test_strided_streams_partition_the_loader_stream(root, kind, n, tmp_path):
    """Ranks 0..n-1 of ``BatchLoader.strided`` give batches r, r + n, ... of
    the one-process stream with their ordinals: cold (every rank collating
    its own batches), cold with a batch cache (rank 0 collating all and
    publishing the cache, which then equals the one-process stream), and
    through that cache."""
    _, pds = datasets(root, kind)

    def loader(cache=None):
        return port_ds.BatchLoader(pds, 3, shuffle=False, drop_last=False, num_threads=2,
                                   batch_cache_dir=cache)

    want = list(loader())
    assert len(want) > n
    cache = str(tmp_path / "batches")
    for ranks in ("cold", "publishing", "warm"):
        got = {}
        for r in range(n):
            strided = list(loader(None if ranks == "cold" else cache).strided(r, n))
            assert [i for i, _ in strided] == list(range(r, len(want), n)), (ranks, r)
            got.update(strided)
        assert_same_batches([got[i] for i in range(len(want))], want)
    assert_same_batches(list(port_bc.valid_batch_cache(cache, loader(cache)._batch_fingerprint())),
                        want)
    with pytest.raises(ValueError, match="shuffle=False"):
        next(port_ds.BatchLoader(pds, 3, shuffle=True).strided(0, n))
