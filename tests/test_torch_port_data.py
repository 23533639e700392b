"""The port's host data pipeline against the TPU package's, on fixture trees.

The two packages' fixture writers are compared member by member (``np.savez``
stamps each zip with the time, so bytes differ). Then, on one tree, obj-only
and obj+rel: every ``Sample`` field by field, ``collate`` at each default
bucket, and the ``BatchLoader``'s batches value for value (dtypes included)
shuffled at epoch 1, unshuffled, with ``drop_last`` off and sharded two
ways; the native tar index against the Python one; the synonym table and
the vocabularies; and a spawned process pool against the thread pool.
"""

import dataclasses
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from structured_alignment_vqa_tpu.data import dataset as jax_ds
from structured_alignment_vqa_tpu.data import fixtures as jax_fixtures
from structured_alignment_vqa_tpu.data import synonyms as jax_synonyms
from structured_alignment_vqa_tpu.data import tar_reader as jax_tar
from structured_alignment_vqa_tpu.data import vocab as jax_vocab
from structured_alignment_vqa_tpu_torch.data import dataset as port_ds
from structured_alignment_vqa_tpu_torch.data import fixtures as port_fixtures
from structured_alignment_vqa_tpu_torch.data import synonyms as port_synonyms
from structured_alignment_vqa_tpu_torch.data import tar_reader as port_tar
from structured_alignment_vqa_tpu_torch.data import vocab as port_vocab

FIXTURE = dict(n_images=6, n_questions=40, seed=3, n_obj_range=(2, 6), n_classes=24,
               class_feature_sigma=0.5, p_detector_correct=0.5, p_easy=0.3)
KINDS = {
    "obj": dict(maxlen=128, topn=2, min_cnt=50, only_obj=True, pred_rel=True, with_loc=True),
    "objrel": dict(maxlen=256, topn=2, min_cnt=50, only_obj=False, pred_rel=True,
                   with_loc=True),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    jax_root = str(tmp_path_factory.mktemp("jax_tree"))
    port_root = str(tmp_path_factory.mktemp("port_tree"))
    jax_fixtures.write_fixture(jax_root, **FIXTURE)
    port_fixtures.write_fixture(port_root, **FIXTURE)
    return jax_root, port_root


def configs(root, kind, **kw):
    args = dict(KINDS[kind], data_dir=root, **kw)
    return jax_ds.DataConfig(**args), port_ds.DataConfig(**args)


def datasets(root, kind, split="train"):
    jcfg, pcfg = configs(root, kind)
    return jax_ds.GQASuperNodeDataset(split, jcfg), port_ds.GQASuperNodeDataset(split, pcfg)


def assert_same_value(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def assert_same_batch(jb, pb, what=""):
    for f in dataclasses.fields(jb):
        assert_same_value(getattr(jb, f.name), getattr(pb, f.name), f"{what} {f.name}")


def tar_members(path):
    out = []
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            out.append((m.name, tf.extractfile(m).read()))
    return out


def assert_same_member(name, a: bytes, b: bytes):
    if name.endswith(".npz"):
        za = np.load(io.BytesIO(a), allow_pickle=True)
        zb = np.load(io.BytesIO(b), allow_pickle=True)
        assert sorted(za.files) == sorted(zb.files), name
        for key in za.files:
            if za[key].dtype == object:
                assert za[key].tolist() == zb[key].tolist(), (name, key)
            else:
                assert_same_value(za[key], zb[key], f"{name}:{key}")
    elif name.endswith(".json"):
        assert json.loads(a) == json.loads(b), name
    else:
        assert a == b, name


def test_fixture_trees_are_equal_member_by_member(trees):
    jax_root, port_root = trees

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(jax_root) == files(port_root)
    n_members = 0
    for rel in files(jax_root):
        a, b = os.path.join(jax_root, rel), os.path.join(port_root, rel)
        if rel.endswith(".tar"):
            ma, mb = tar_members(a), tar_members(b)
            assert [n for n, _ in ma] == [n for n, _ in mb], rel
            for (name, da), (_, db) in zip(ma, mb):
                assert_same_member(name, da, db)
            n_members += len(ma)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert_same_member(rel, fa.read(), fb.read())
    assert n_members == FIXTURE["n_images"] + FIXTURE["n_questions"] + FIXTURE["n_questions"] // 4


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_sample_equals_jax_field_by_field(trees, kind):
    jds, pds = datasets(trees[0], kind)
    assert len(jds) == len(pds) == FIXTURE["n_questions"]
    n_valid = 0
    for i in range(len(jds)):
        js, ps = jds.sample(i), pds.sample(i)
        assert (js is None) == (ps is None), i
        if js is None:
            continue
        n_valid += 1
        for f in dataclasses.fields(js):
            assert_same_value(getattr(js, f.name), getattr(ps, f.name), f"sample {i} {f.name}")
    assert n_valid > len(jds) // 2
    if kind == "objrel":
        assert any(pds.sample(i).micro_pos_rel is not None for i in range(len(pds))
                   if pds.sample(i) is not None)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_collate_at_each_default_bucket_equals_jax(trees, kind):
    jcfg, pcfg = configs(trees[0], kind)
    jds, pds = datasets(trees[0], kind)
    jb_list, pb_list = jax_ds.default_buckets(jcfg), port_ds.default_buckets(pcfg)
    assert [dataclasses.astuple(b) for b in jb_list] == [dataclasses.astuple(b) for b in pb_list]
    samples = [(jds.sample(i), pds.sample(i)) for i in range(12)]
    for jbucket, pbucket in zip(jb_list, pb_list):
        jb = jax_ds.collate([j for j, _ in samples], jbucket, jcfg.topn)
        pb = port_ds.collate([p for _, p in samples], pbucket, pcfg.topn)
        assert_same_batch(jb, pb, f"bucket {pbucket}")
        assert int(pb.sample_valid.sum()) > 0


LOADERS = {
    "shuffled_epoch1": dict(shuffle=True, seed=5, epoch=1),
    "unshuffled": dict(shuffle=False),
    "no_drop_last": dict(shuffle=False, drop_last=False),
    "shard0of2": dict(shuffle=True, seed=2, shard_idx=0, num_shards=2, drop_last=False),
    "shard1of2": dict(shuffle=True, seed=2, shard_idx=1, num_shards=2, drop_last=False),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("mode", sorted(LOADERS))
def test_batch_loader_equals_jax_value_for_value(trees, kind, mode):
    jds, pds = datasets(trees[0], kind)
    kw = dict(LOADERS[mode])
    epoch = kw.pop("epoch", 0)
    jl = jax_ds.BatchLoader(jds, 4, num_threads=2, **kw)
    pl = port_ds.BatchLoader(pds, 4, num_threads=2, **kw)
    jl.set_epoch(epoch)
    pl.set_epoch(epoch)
    assert np.array_equal(jl._indices(), pl._indices())
    jbatches, pbatches = list(jl), list(pl)
    assert len(jbatches) == len(pbatches) > 0
    for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
        assert_same_batch(jb, pb, f"batch {i}")
    assert jl.last_dropped == pl.last_dropped


def test_native_tar_index_equals_python_and_jax(trees):
    from structured_alignment_vqa_tpu_torch.native import tar_index

    root = trees[0]
    assert tar_index.available()
    for name in ("gt_bua_npz.tar", "train.tar", "val.tar"):
        path = os.path.join(root, name)
        native = tar_index.index_tar(path)
        assert native == port_tar._python_index(path) == jax_tar._python_index(path)
        idx = port_tar.TarIndex(path)
        assert idx.indexed_by == "native"
        assert port_tar.TarIndex(path, prefer_native=False).indexed_by == "python"
        for key in list(idx.keys())[:3]:
            assert idx.read(key) == jax_tar.TarIndex(path).read(key)


def test_native_library_builds_into_build_dir_at_first_use():
    from structured_alignment_vqa_tpu_torch import native

    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "build"
    assert native.BUILD_DIR.parent == native._SRC.parents[2]
    assert native._SRC.read_bytes() == (
        native._SRC.parents[2] / "structured_alignment_vqa_tpu/native/tar_index.cpp").read_bytes()


def test_word_converter_and_vocabularies_equal_jax(trees):
    root = trees[0]
    assert port_synonyms.synonym_dict() == jax_synonyms.synonym_dict()
    assert port_synonyms.word_converter() == jax_synonyms.word_converter()
    assert len(port_synonyms.synonym_dict()) > 300
    graph = os.path.join(root, "preprocessed/de.vocab.composite2.tsv")
    assert port_vocab.load_graph_vocab(graph) == jax_vocab.load_graph_vocab(graph)
    answers = os.path.join(root, "preprocessed/en.vocab.tsv")
    for min_cnt in (1, 50, 101):
        assert (port_vocab.load_answer_vocab(answers, min_cnt)
                == jax_vocab.load_answer_vocab(answers, min_cnt))
    for name in ("objects_vocab.txt", "attributes_vocab.txt"):
        path = os.path.join(root, name)
        assert port_vocab.load_object_vocab(path) == jax_vocab.load_object_vocab(path)


def test_spawned_process_pool_loader_equals_thread_loader(trees):
    _, pds = datasets(trees[0], "obj")
    threads = list(port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False, num_threads=2))
    procs = list(port_ds.BatchLoader(pds, 4, shuffle=False, drop_last=False, num_procs=2))
    assert len(threads) == len(procs) > 0
    for i, (a, b) in enumerate(zip(threads, procs)):
        assert_same_batch(a, b, f"batch {i}")


def test_collate_dtypes_are_those_the_transfer_ships(trees):
    """Masks and graphs int8, ids int32, features float32 (data/batch.py)."""
    _, pds = datasets(trees[0], "objrel")
    b = next(iter(port_ds.BatchLoader(pds, 4, shuffle=False)))
    int8 = ("vis_mask", "q_mask", "q_graph", "macro_mask", "macro_graph", "micro_obj_mask")
    for f in dataclasses.fields(b):
        value = getattr(b, f.name)
        if value is None:
            continue
        want = np.float32 if f.name == "vis_fea" else np.int8 if f.name in int8 else np.int32
        assert value.dtype == want, f.name


@pytest.mark.parametrize("kw", [dict(n_pack=2, pack_bucket=1), dict(n_pack=3, shuffle=False,
                                                                   drop_last=False),
                                dict(tight=True, shuffle=False)],
                         ids=["n_pack2", "n_pack3_no_drop_last", "tight"])
def test_packed_loader_equals_jax_value_for_value(trees, kw):
    """Packed rows (data/packing.py), and tight=True, batch for batch as
    the TPU package's loader gives them; obj+rel refuses to pack on both."""
    jds, pds = datasets(trees[0], "obj")
    jbatches = list(jax_ds.BatchLoader(jds, 4, num_threads=2, **kw))
    pl = port_ds.BatchLoader(pds, 4, num_threads=2, **kw)
    pbatches = list(pl)
    assert len(jbatches) == len(pbatches) > 0
    for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
        assert_same_batch(jb, pb, f"batch {i}")
    assert pb.vis_seg is not None and pb.answer.shape == (4, kw.get("n_pack", 1))
    _, rel = datasets(trees[0], "objrel")
    with pytest.raises(ValueError, match="only_obj"):
        port_ds.BatchLoader(rel, 4, **kw)


@pytest.mark.parametrize("grid_self_connect", [False, True], ids=["plain", "grid"])
def test_array_loader_equals_jax_value_for_value(grid_self_connect):
    """The legacy whole-array loader (data/array_dataset.py): every array
    value for value, OOV words as UNK (the reference's '400001'), samples
    longer than maxlen or without region features skipped, edges out of
    range ignored; and the shuffled batch indices with their off-by-one."""
    from structured_alignment_vqa_tpu.data import array_dataset as jax_arrays
    from structured_alignment_vqa_tpu_torch.data import array_dataset as port_arrays

    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(12)]
    de2idx = {w: 20 + i for i, w in enumerate(words[:9])}   # w9-w11 are OOV
    de2idx["</s>"] = 5
    en2idx = {"yes": 2, "no": 3}
    n, maxlen = 9, 12
    # a symbolic sentence may exceed maxlen (the sample is skipped); a visual
    # one plus its regions must fit, in both packages as in the reference
    sents = [" ".join(rng.choice(words, size=int(rng.integers(1, k))))
             for k in [14] * n + [8] * n]
    kw = dict(
        sents_syb=sents[:n], sents_vis=sents[n:],
        answers=[str(rng.choice(["yes", "no", "maybe"])) for _ in range(n)],
        edges_syb=[rng.integers(0, maxlen + 3, size=(int(rng.integers(0, 4)), 2)).tolist()
                   for _ in range(n)],
        edges_vis=[rng.integers(0, maxlen + 3, size=(int(rng.integers(0, 4)), 2)).tolist()
                   for _ in range(n)],
        region_feats=[np.ones((int(rng.integers(0, 4)), 4), np.float32) for _ in range(n)],
        q_lengths=[int(rng.integers(0, 3)) for _ in range(n)],
        de2idx=de2idx, en2idx=en2idx, maxlen=maxlen, grid_self_connect=grid_self_connect)
    want, got = jax_arrays.create_arrays(**kw), port_arrays.create_arrays(**kw)
    assert 0 < got.X_syb.shape[0] < n          # some samples are skipped
    assert (got.X_syb == port_arrays.UNK).any() and port_arrays.UNK == 400001
    for name in ("X_syb", "X_vis", "Y"):
        assert_same_value(getattr(want, name), getattr(got, name), name)
    for name in ("G_syb", "G_vis"):
        for i, (a, b) in enumerate(zip(getattr(want, name), getattr(got, name))):
            assert_same_value(a, b, f"{name}[{i}]")
    assert all(np.array_equal(a, b) for a, b in zip(want.X0, got.X0))
    for total, size, seed in ((100, 16, 0), (33, 8, 3), (8, 8, 1)):
        assert (list(port_arrays.get_batch_indices(total, size, seed))
                == list(jax_arrays.get_batch_indices(total, size, seed)))
