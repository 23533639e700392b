"""GQA super-node dataset, static-shape collate, and the prefetching loader:
the port's own copy of the TPU package's ``data/dataset.py``, which gives
the same samples and the same batches, value for value.

Host-pipeline redesign of the reference loader family:

* tar archives indexed once (`tar_reader.TarIndex`) instead of per-item
  re-opens (`...onlyobj.py:246-266`);
* samples that the reference drops via ``return None`` + collate filtering
  become ``sample_valid=0`` rows, keeping the batch dimension fixed;
* padding targets come from a small set of shape *buckets* instead of the
  per-batch dynamic maxima at `...onlyobj.py:351-420`, so a batch takes one
  of a handful of shapes, not one per batch (the TPU package's buckets, kept
  as they are so that the two packages' batches are identical);
* a thread pool (or a spawned process pool) prefetches and assembles
  batches while the device computes;
* per-host sharding is index striding (``shard_idx::num_shards``), replacing
  ``DistributedSampler`` (`main_itp_ddp_tar_super_node.py:222-225`).

Batches hold numpy arrays; ``data/transfer.py`` moves them to the device.
With ``n_pack > 1`` (or ``tight=True``) the loader packs samples into rows
through ``data/packing.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.data.graph_builder import (
    PAD_NODE,
    SuperNodeGraphBuilder,
    quantize_bbox,
)
from structured_alignment_vqa_tpu_torch.data.synonyms import word_converter
from structured_alignment_vqa_tpu_torch.data.tar_reader import TarIndex, TarMemberList
from structured_alignment_vqa_tpu_torch.data.vocab import (
    load_answer_vocab,
    load_graph_vocab,
    load_object_vocab,
)
from structured_alignment_vqa_tpu_torch.models.glove import SPECIALS

PAD = SPECIALS.PAD
UNK = SPECIALS.UNK
LOC_PAD = SPECIALS.LOC_PAD


@dataclasses.dataclass
class DataConfig:
    """Paths + knobs, mirroring the reference CLI flags (`main:435-469,487-488`)."""

    data_dir: str
    fea_tar: str = "gt_bua_npz.tar"
    q_tar: str = "train.tar"
    g_tar: str = "gt_bua_npz.tar"
    gt_relation_fn: str = "GT_relations_dict_compsite.json"
    obj_vocab_fn: str = "objects_vocab.txt"
    attr_vocab_fn: str = "attributes_vocab.txt"
    enc_vocab_fn: str = "preprocessed/de.vocab.composite2.tsv"
    ans_vocab_fn: str = "preprocessed/en.vocab.tsv"
    bbox_bin_num: int = 64
    min_cnt: int = 50
    maxlen: int = 450
    topn: int = 5
    with_loc: bool = True
    only_obj: bool = True
    pred_rel: bool = False
    seed: int = 0
    # 'drop' replicates the reference (ragged topN candidate lists kill the
    # sample via its bare except, `...onlyobj.py:330-334`); 'pad' keeps the
    # sample with PAD-filled candidate slots.
    ragged_candidates: str = "drop"
    # per-image feature/graph cache entries (GQA averages ~10 questions per
    # image; npz parsing dominates the per-sample cost otherwise)
    image_cache_size: int = 512


@dataclasses.dataclass
class Sample:
    """One converted sample (pre-padding)."""

    vis_fea: np.ndarray           # (O, 2048)
    macro_ids: np.ndarray         # (Ls,)
    macro_edges: List[Tuple[int, int]]
    obj_locs: np.ndarray          # (O,)
    micro_pos_obj: np.ndarray     # (O, topN)
    micro_neg_obj: np.ndarray     # (O, topN)
    q_ids: np.ndarray             # (Lq,)
    q_edges: List[Tuple[int, int]]
    answer: int
    micro_pos_rel: Optional[np.ndarray] = None   # (R,)
    micro_neg_rel: Optional[np.ndarray] = None
    micro_pos_rel_loc: Optional[np.ndarray] = None  # (R, 5)
    micro_neg_rel_loc: Optional[np.ndarray] = None  # (R, 5)


class GQASuperNodeDataset:
    """Production dataset: super-node graphs from detected features + GT scene
    graphs (`data_loader_itp_bbox_super_node[_onlyobj].py`)."""

    def __init__(self, split: str, cfg: DataConfig):
        self.split = split
        self.cfg = cfg
        d = cfg.data_dir

        self.enc_w2id, _ = load_graph_vocab(os.path.join(d, cfg.enc_vocab_fn))
        self.ans_w2id, _ = load_answer_vocab(os.path.join(d, cfg.ans_vocab_fn), cfg.min_cnt)

        self.fea_tar = TarIndex(os.path.join(d, cfg.fea_tar))
        g_path = os.path.join(d, cfg.g_tar)
        self.g_tar = self.fea_tar if g_path == self.fea_tar.path else TarIndex(g_path)
        self.q_tar = TarIndex(os.path.join(d, cfg.q_tar))
        self.questions = TarMemberList(self.q_tar, ".json")

        graph_name = "train_sceneGraphs.json" if split == "train" else "val_sceneGraphs.json"
        with open(os.path.join(d, graph_name)) as f:
            self.gt_graph = json.load(f)
        with open(os.path.join(d, cfg.gt_relation_fn)) as f:
            gt_relations = json.load(f)

        vg_classes = load_object_vocab(os.path.join(d, cfg.obj_vocab_fn))
        vg_attrs = load_object_vocab(os.path.join(d, cfg.attr_vocab_fn))

        self.builder = SuperNodeGraphBuilder(
            vg_classes, vg_attrs, gt_relations,
            topn=cfg.topn, with_loc=cfg.with_loc,
            only_obj=cfg.only_obj, pred_rel=cfg.pred_rel,
        )
        self.word_converter = word_converter()

        import functools

        @functools.lru_cache(maxsize=max(cfg.image_cache_size, 1))
        def _load_image(image_id: str):
            # feature tar and graph tar are the same archive in the production
            # layout (`submit.py` passes gt_bua_npz.tar for both): decode the
            # member once instead of twice (a cache miss costs ~3 ms in npz
            # decode; this halves it)
            g_npz = self.g_tar.read_npz(image_id, allow_pickle=True)
            if self.g_tar is self.fea_tar and "x" in g_npz:
                vis_fea = np.asarray(g_npz["x"], dtype=np.float32)
            else:
                vis_fea = np.asarray(self.fea_tar.read_npz(image_id)["x"], dtype=np.float32)
            bbox = quantize_bbox(
                g_npz["bbox"], g_npz["image_w"], g_npz["image_h"], cfg.bbox_bin_num
            )
            data_info = g_npz["info"].tolist()
            return vis_fea, bbox, data_info

        self._load_image = _load_image

    def __len__(self) -> int:
        return len(self.questions)

    # -- tokenization -------------------------------------------------------------

    def _tok(self, node) -> int:
        if node is PAD_NODE or node == PAD:
            return PAD
        node = self.word_converter.get(node, node)
        return self.enc_w2id.get(node, UNK)

    def _tok_candidates(self, cands: List[List[str]], topn: int) -> Optional[np.ndarray]:
        rows = []
        for row in cands:
            ids = [self._tok(c) for c in row]
            if len(ids) != topn:
                if self.cfg.ragged_candidates == "drop":
                    return None
                ids = ids + [PAD] * (topn - len(ids))
            rows.append(ids)
        return np.asarray(rows, dtype=np.int64).reshape(len(cands), topn)

    # -- sample construction ------------------------------------------------------

    def sample(self, index: int) -> Optional[Sample]:
        """Mirrors ``__getitem__`` (`...onlyobj.py:244-334`) including its
        per-sample fault tolerance: any failure returns None."""
        try:
            return self._sample(index)
        except Exception:
            return None

    def _sample(self, index: int) -> Optional[Sample]:
        cfg = self.cfg
        qinfo = self.questions.read_json(index)
        answer = self.ans_w2id.get(qinfo["answer"], 0)
        image_id = qinfo["image_id"]

        gt_graph = self.gt_graph[image_id]
        vis_fea, bbox, data_info = self._load_image(image_id)

        rng = np.random.default_rng((cfg.seed, index))
        graph = self.builder.convert(data_info, bbox, gt_graph, rng)

        macro_ids = np.asarray([self._tok(n) for n in graph.nodes], dtype=np.int64)
        q_ids = np.asarray(
            [self.enc_w2id.get(qn, UNK) for qn in qinfo["node_list"]], dtype=np.int64
        )
        if len(macro_ids) + len(q_ids) >= cfg.maxlen:
            return None

        pos = self._tok_candidates(graph.micro_pos_obj, cfg.topn)
        neg = self._tok_candidates(graph.micro_neg_obj, cfg.topn)
        if pos is None or neg is None:
            return None

        s = Sample(
            vis_fea=vis_fea,
            macro_ids=macro_ids,
            macro_edges=list(graph.edges),
            obj_locs=np.asarray(graph.obj_locs, dtype=np.int64),
            micro_pos_obj=pos,
            micro_neg_obj=neg,
            q_ids=q_ids,
            q_edges=list(qinfo["edge_pair"]),
            answer=int(answer),
        )
        if not cfg.only_obj:
            # PAD relation slots tokenize to UNK, not PAD: the reference's
            # micro-rel tokenization has no PAD special case, so the PAD
            # sentinel falls through the vocab lookup
            # (`data_loader_itp_bbox_super_node.py:341-349`)
            def tok_rel(n):
                if n is PAD_NODE or n == PAD:
                    return UNK
                return self._tok(n)

            s.micro_pos_rel = np.asarray(
                [tok_rel(n) for n in graph.micro_pos_rel], dtype=np.int64
            )
            s.micro_neg_rel = np.asarray(
                [tok_rel(n) for n in graph.micro_neg_rel], dtype=np.int64
            )
            s.micro_pos_rel_loc = (
                np.asarray(graph.micro_pos_rel_loc, dtype=np.int64).reshape(-1, 5)
            )
            nl = np.asarray(graph.micro_neg_rel_loc, dtype=np.int64).reshape(-1, 5)
            s.micro_neg_rel_loc = nl
        return s


# ---- static-shape collate -------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class BatchShape:
    """Padding target: (visual regions, macro nodes, question nodes, relations)."""

    lv: int
    ls: int
    lq: int
    n_rel: int = 0

    def fits(self, s: Sample) -> bool:
        if s.vis_fea.shape[0] > self.lv or len(s.macro_ids) > self.ls or len(s.q_ids) > self.lq:
            return False
        if s.micro_pos_rel is not None and len(s.micro_pos_rel) > self.n_rel:
            return False
        return True


# The TPU package's lane width: its buckets make encoder sequence lengths
# multiples of it. Kept so that the port's batches equal the TPU package's.
LANE = 128


def _align_ls(ls: int, lq: int) -> int:
    """Largest macro budget <= ls such that ls + lq is a multiple of LANE.

    The encoders attend over (modality ++ question) sequences; on the TPU a
    length just over a 128 boundary padded a full extra lane tile in the
    attention matmuls.
    """
    total = ((ls + lq) // LANE) * LANE
    return max(total - lq, LANE - lq)


def default_buckets(cfg: DataConfig, maxlen_q: int = 40, maxlen_v: int = 100) -> List[BatchShape]:
    """Three nested buckets covering the production shape envelope, with the
    combined encoder length aligned to ``LANE``, as in the TPU package."""
    ls_max = cfg.maxlen
    n_rel = 0 if cfg.only_obj else 1600
    return [
        BatchShape(maxlen_v // 2, _align_ls(ls_max // 4, maxlen_q // 2), maxlen_q // 2, n_rel // 4),
        BatchShape(maxlen_v, _align_ls(ls_max // 2, maxlen_q), maxlen_q, n_rel // 2),
        BatchShape(maxlen_v, _align_ls(ls_max, maxlen_q), maxlen_q, n_rel),
    ]


def _square(mask_len: int, size: int) -> np.ndarray:
    m = np.zeros((size, size), np.int8)
    m[:mask_len, :mask_len] = 1
    return m


def _scatter_edges(a: np.ndarray, edges, size: int) -> None:
    """Scatter an edge list (pairs or (k, 2) array) into square ``a``."""
    if len(edges):
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        keep = (e[:, 0] < size) & (e[:, 1] < size)
        e = e[keep]
        a[e[:, 0], e[:, 1]] = 1


def _edges_to_adj(edges, size: int) -> np.ndarray:
    a = np.zeros((size, size), np.int8)
    _scatter_edges(a, edges, size)
    return a


def collate(
    samples: Sequence[Optional[Sample]],
    shape: BatchShape,
    topn: int,
    fea_dim: int = 2048,
) -> VQABatch:
    """Pad samples to ``shape``; None / oversized samples become invalid rows.

    Field-for-field equivalent of the reference collate
    (`...onlyobj.py:341-445`) at a fixed target shape. Emits **numpy** leaves
    (float32 features, int8 masks and graphs, int32 ids): the move to the
    device is ``data/transfer.py``'s, not the loader's.
    """
    b = len(samples)
    lv, ls, lq, n_rel = shape.lv, shape.ls, shape.lq, max(shape.n_rel, 1)

    vis = np.zeros((b, lv, fea_dim), np.float32)
    vis_mask = np.zeros((b, lv, lv), np.int8)
    macro = np.full((b, ls), PAD, np.int32)
    macro_mask = np.zeros((b, ls, ls), np.int8)
    macro_graph = np.zeros((b, ls, ls), np.int8)
    obj_loc = np.full((b, lv), LOC_PAD, np.int32)
    mpos = np.full((b, lv, topn), PAD, np.int32)
    mneg = np.full((b, lv, topn), PAD, np.int32)
    mmask = np.zeros((b, lv, topn), np.int8)
    q = np.full((b, lq), PAD, np.int32)
    q_mask = np.zeros((b, lq, lq), np.int8)
    q_graph = np.zeros((b, lq, lq), np.int8)
    prel = np.full((b, n_rel), PAD, np.int32)
    nrel = np.full((b, n_rel), PAD, np.int32)
    prel_loc = np.full((b, n_rel, 5), LOC_PAD, np.int32)
    nrel_loc = np.full((b, n_rel, 5), LOC_PAD, np.int32)
    answer = np.zeros((b,), np.int32)
    valid = np.zeros((b,), np.int32)

    for i, s in enumerate(samples):
        if s is None or not shape.fits(s):
            continue
        no = s.vis_fea.shape[0]
        nm = len(s.macro_ids)
        nq = len(s.q_ids)
        vis[i, :no] = s.vis_fea
        vis_mask[i, :no, :no] = 1    # in-place _square (hot: collate is the
        macro[i, :nm] = s.macro_ids  # cached-epoch bottleneck, DESIGN.md)
        macro_mask[i, :nm, :nm] = 1
        _scatter_edges(macro_graph[i], s.macro_edges, ls)
        k = min(len(s.obj_locs), lv)
        obj_loc[i, :k] = s.obj_locs[:k]
        mpos[i, :s.micro_pos_obj.shape[0]] = s.micro_pos_obj
        mneg[i, :s.micro_neg_obj.shape[0]] = s.micro_neg_obj
        mmask[i, :k] = 1
        q[i, :nq] = s.q_ids
        q_mask[i, :nq, :nq] = 1
        _scatter_edges(q_graph[i], s.q_edges, lq)
        if s.micro_pos_rel is not None and len(s.micro_pos_rel):
            nr = len(s.micro_pos_rel)
            prel[i, :nr] = s.micro_pos_rel
            prel_loc[i, :nr] = s.micro_pos_rel_loc
            nn = len(s.micro_neg_rel)
            nrel[i, :nn] = s.micro_neg_rel
            nrel_loc[i, :nn] = s.micro_neg_rel_loc
        answer[i] = s.answer
        valid[i] = 1

    return VQABatch(
        vis_fea=vis,
        vis_mask=vis_mask,
        q_ipt=q,
        q_mask=q_mask,
        q_graph=q_graph,
        macro_ipt=macro,
        macro_mask=macro_mask,
        macro_graph=macro_graph,
        macro_obj_loc=obj_loc,
        micro_pos_obj=mpos,
        micro_neg_obj=mneg,
        micro_obj_mask=mmask,
        micro_pos_rel=prel,
        micro_neg_rel=nrel,
        micro_pos_rel_loc=prel_loc,
        micro_neg_rel_loc=nrel_loc,
        answer=answer,
        sample_valid=valid,
    )


# ---- prefetching loader ---------------------------------------------------------

# Process-pool worker state: one dataset instance per worker process (tar fds
# and scene-graph dicts are not picklable/shareable; each worker re-opens).
_WORKER_DS = None


def _init_worker(ds_cls, split, cfg):
    global _WORKER_DS
    _WORKER_DS = ds_cls(split, cfg)


def _worker_sample(idx: int):
    return _WORKER_DS.sample(idx)


class BatchLoader:
    """Thread-pool prefetching batch iterator with shape bucketing.

    Each epoch: shuffle (seeded by epoch, like ``sampler.set_epoch`` at
    `main:263`), stride by host shard, prefetch samples, group them into the
    smallest bucket that fits, and emit fixed-shape `VQABatch`es of numpy
    arrays.
    """

    def __init__(
        self,
        dataset: GQASuperNodeDataset,
        batch_size: int,
        buckets: Optional[List[BatchShape]] = None,
        shuffle: bool = True,
        seed: int = 0,
        shard_idx: int = 0,
        num_shards: int = 1,
        num_threads: int = 8,
        num_procs: int = 0,
        drop_last: bool = True,
        prefetch: int = 64,
        n_pack: int = 1,
        pack_bucket: Optional[int] = None,
        tight: bool = False,
        cache_dir: Optional[str] = None,
        batch_cache_dir: Optional[str] = None,
        batch_replay_dir: Optional[str] = None,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.buckets = sorted(buckets or default_buckets(dataset.cfg))
        self.shuffle = shuffle
        self.seed = seed
        self.shard_idx = shard_idx
        self.num_shards = num_shards
        self.num_threads = num_threads
        # >0: sample construction in worker *processes* — the graph building
        # and tokenization are pure-Python (GIL-bound), so threads only help
        # with the IO share. This is the torch num_workers analogue.
        self.num_procs = num_procs
        self.drop_last = drop_last
        self.prefetch = prefetch
        # >1: sequence packing, up to n_pack samples a row (first-fit online
        # into open rows; data/packing.py), only_obj only. Packed samples go
        # to ``buckets[pack_bucket]`` (default: the largest bucket) instead
        # of the smallest bucket that fits: at the production length mix the
        # smallest bucket's rows hold one sample each, so smallest-fit
        # routing would leave nothing to pack. A sample too big for the pack
        # bucket falls back to smallest-fit (its rows pack whatever still
        # fits).
        self.n_pack = n_pack
        self.pack_bucket = (
            self.buckets[-1 if pack_bucket is None else pack_bucket]
            if n_pack > 1 else None
        )
        # tight=True with n_pack=1: one sample a row, but through the packed
        # collate, i.e. tight-bucket semantics (positions restart per sample,
        # no attending of padding tokens). The eval of a packed training run
        # uses it, so that train and eval encode a sample alike; routing
        # stays smallest-fit.
        self.tight = tight or n_pack > 1
        if self.tight and not dataset.cfg.only_obj:
            raise ValueError("sequence packing requires only_obj=True "
                             "(the relation-MIL compacted indexing is per-sample)")
        # cross-epoch preprocessed-sample cache (data/sample_cache.py): the
        # first full pass persists every converted Sample; later epochs
        # stream mmap'd arrays instead of re-reading tars / re-building
        # graphs. Sound because Sample is a pure function of (cfg, index)
        # — negative sampling is seeded by (cfg.seed, index), not epoch.
        self.cache_dir = cache_dir
        # materialized *collated batches* (data/batch_cache.py): valid only
        # for a fixed stream (shuffle=False) — val eval / serving, where the
        # reference redoes the identical host pipeline every epoch. Later
        # passes stream mmap'd VQABatch arrays with no host compute at all.
        if batch_cache_dir and shuffle:
            raise ValueError(
                "batch_cache_dir requires shuffle=False (a shuffled stream "
                "differs every epoch; use cache_dir — the sample cache — for "
                "training, or batch_replay_dir to freeze batch composition "
                "and reshuffle batch order)"
            )
        self.batch_cache_dir = batch_cache_dir
        # training-side materialized batches: the first epoch builds + persists
        # its collated batches; every later epoch streams them mmap'd in a
        # freshly permuted ORDER (seeded by epoch). Batch composition is
        # frozen at the first materialized epoch (the TPU package's "batch
        # replay", a documented departure from the reference's per-epoch
        # resample).
        if batch_replay_dir and batch_cache_dir:
            raise ValueError("batch_replay_dir and batch_cache_dir are exclusive")
        self.batch_replay_dir = batch_replay_dir
        self.epoch = 0

    def _batch_fingerprint(self) -> str:
        from structured_alignment_vqa_tpu_torch.data.batch_cache import (
            loader_fingerprint,
        )

        return loader_fingerprint(
            f"{self.ds.split}/{self.shard_idx}of{self.num_shards}",
            self.ds.cfg, self.batch_size, self.buckets, self.n_pack,
            self.pack_bucket, self.tight, self.drop_last,
        )

    def _sample_stream(self, idx):
        """Yield converted samples for ``idx`` in order, from the cache when
        one is valid, else from the dataset (building the cache en route)."""
        from structured_alignment_vqa_tpu_torch.data.sample_cache import (
            SampleCacheWriter, valid_cache,
        )

        cache = valid_cache(self.cache_dir, self.ds.split, self.ds.cfg)
        if cache is not None:
            for i in idx:
                yield cache.sample(int(i))
            return

        if self.num_procs > 0:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: by the time the pool starts the parent holds a
            # CUDA context and live threads (the shipper, the allocator's),
            # and a forked child inherits a CUDA state it cannot use and
            # locks that may be held. Spawned workers import the package
            # (and torch) afresh, build their own dataset view in the
            # initializer and never touch torch.cuda.
            ex_cm = ProcessPoolExecutor(
                max_workers=self.num_procs,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker,
                initargs=(type(self.ds), self.ds.split, self.ds.cfg),
            )
            map_fn, map_target = ex_cm.map, _worker_sample
        else:
            ex_cm = ThreadPoolExecutor(max_workers=self.num_threads)
            map_fn, map_target = ex_cm.map, self.ds.sample

        writer = None
        if self.cache_dir and self.num_shards == 1:
            # single-host only: a sharded pass can never cover every index,
            # so finalize() would always discard
            writer = SampleCacheWriter(
                self.cache_dir, len(self.ds), self.ds.split, self.ds.cfg
            )
        try:
            with ex_cm:
                for i, s in zip(idx, map_fn(map_target, idx, chunksize=16)):
                    if writer is not None:
                        writer.add(int(i), s)
                    yield s
            if writer is not None:
                writer.finalize()
                writer = None
        finally:
            if writer is not None:  # interrupted epoch: no partial publish
                writer.abort()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def replay_cache(self):
        """The materialized replay/batch cache, if built and valid (None
        otherwise)."""
        from structured_alignment_vqa_tpu_torch.data.batch_cache import valid_batch_cache

        root = self.batch_replay_dir or self.batch_cache_dir
        if not root:
            return None
        return valid_batch_cache(root, self._batch_fingerprint())

    def replay_order(self, epoch: int, n: int) -> np.ndarray:
        """The batch order replay uses for ``epoch``."""
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, 0x5EBA, epoch)).shuffle(order)
        return order

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx[self.shard_idx:: self.num_shards]

    def _bucket_for(self, s: Sample) -> Optional[BatchShape]:
        for b in self.buckets:
            if b.fits(s):
                return b
        return None

    def __iter__(self) -> Iterator[VQABatch]:
        root = self.batch_replay_dir or self.batch_cache_dir
        if not root:
            yield from self._iter_build()
            return
        from structured_alignment_vqa_tpu_torch.data.batch_cache import (
            BatchCacheWriter, valid_batch_cache,
        )

        fp = self._batch_fingerprint()
        cache = valid_batch_cache(root, fp)
        if cache is not None:
            self.last_dropped = cache.meta.get("n_samples_dropped", 0)
            if self.batch_replay_dir:
                for i in self.replay_order(self.epoch, len(cache)):
                    yield cache.batch(int(i))
            else:
                yield from cache
            return
        writer = BatchCacheWriter(root, fp)
        try:
            for b in self._iter_build():
                writer.add(b)
                yield b
            writer.finalize(self.last_dropped)
            writer = None
        finally:
            if writer is not None:  # interrupted pass: no partial publish
                writer.abort()

    def strided(self, rank: int, n: int) -> Iterator[Tuple[int, VQABatch]]:
        """``(i, batch)`` for batches ``i = rank, rank + n, ...`` of this
        loader's stream (``shuffle=False``), so that ``n`` servers, each
        with its ``rank``, serve the stream between them.

        Through a valid batch cache a rank reads only its own batches.
        Otherwise every rank runs the whole sample stream, since bucketing
        decides where each batch ends, and collates only its own batches;
        with ``batch_cache_dir`` rank 0 collates them all, to publish the
        cache for later passes.
        """
        if self.shuffle:
            raise ValueError("a strided stream needs shuffle=False")
        cache = self.replay_cache()
        if cache is not None:
            self.last_dropped = cache.meta.get("n_samples_dropped", 0)
            for i in range(rank, len(cache), n):
                yield i, cache.batch(i)
            return
        mine = (lambda i: i % n == rank)
        stream = (iter(self) if self.batch_cache_dir and rank == 0
                  else self._iter_build(keep=mine))
        for i, batch in enumerate(stream):
            if mine(i):
                yield i, batch

    def _iter_build(self, keep: Optional[Callable[[int], bool]] = None
                    ) -> Iterator[Optional[VQABatch]]:
        """The batches of this epoch; with ``keep``, batch ``i`` is
        collated only where ``keep(i)`` holds, and is None elsewhere."""
        idx = self._indices()
        emitted = 0

        def emit(collate_fn, *a):
            nonlocal emitted
            emitted += 1
            return collate_fn(*a) if keep is None or keep(emitted - 1) else None

        topn = self.ds.cfg.topn
        pools: dict = {b: [] for b in self.buckets}
        open_pools: dict = {b: [] for b in self.buckets}
        n_invalid = 0

        packing = self.tight
        if packing:
            from structured_alignment_vqa_tpu_torch.data.packing import PackedRow, collate_packed

        for s in self._sample_stream(idx):
            if s is None:
                n_invalid += 1  # reference drops these pre-batch
                continue
            bucket = self._bucket_for(s)
            if bucket is None:
                n_invalid += 1
                continue
            if packing:
                if self.pack_bucket is not None and self.pack_bucket.fits(s):
                    bucket = self.pack_bucket
                # online first-fit into the *open* rows (a row at n_pack
                # samples leaves the scan list: the scan is the hot spot at
                # bs 128); emit when the sample would need a
                # (batch_size+1)-th row
                rows = pools[bucket]
                opens = open_pools[bucket]
                placed = False
                for r in opens:
                    if r.fits(s):
                        r.add(s)
                        if len(r.samples) >= self.n_pack:
                            opens.remove(r)
                        placed = True
                        break
                if not placed:
                    if len(rows) >= self.batch_size:
                        yield emit(collate_packed,
                                   [r.samples for r in rows], bucket, topn, self.n_pack)
                        rows = pools[bucket] = []
                        opens = open_pools[bucket] = []
                    row = PackedRow(bucket, self.n_pack)
                    row.add(s)
                    rows.append(row)
                    if self.n_pack > 1:
                        opens.append(row)
            else:
                pools[bucket].append(s)
                if len(pools[bucket]) >= self.batch_size:
                    batch_samples = pools[bucket][: self.batch_size]
                    pools[bucket] = pools[bucket][self.batch_size:]
                    yield emit(collate, batch_samples, bucket, topn)
        self.last_dropped = n_invalid
        if self.drop_last:
            # samples stranded in under-full pools are real samples lost to
            # drop_last: count them (a packed row holds up to n_pack)
            for pool in pools.values():
                for entry in pool:
                    self.last_dropped += len(entry.samples) if packing else 1
        else:
            for bucket, pool in pools.items():
                if not pool:
                    continue
                if packing:
                    groups = [r.samples for r in pool]
                    groups += [None] * (self.batch_size - len(groups))
                    yield emit(collate_packed, groups, bucket, topn, self.n_pack)
                else:
                    pad = [None] * (self.batch_size - len(pool))
                    yield emit(collate, pool + pad, bucket, topn)
