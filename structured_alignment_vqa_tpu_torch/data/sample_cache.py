"""Cross-epoch preprocessed-sample cache: the port's own copy of the TPU
package's ``data/sample_cache.py`` (the same record format).

The reference re-reads tars, re-tokenizes, and re-builds graphs on *every*
``__getitem__`` of every epoch (`data_loader_itp_bbox_super_node_onlyobj.py:
244-334`). Here a `Sample` is a *pure function* of (DataConfig, index) —
even the MIL negative sampling draws from ``default_rng((cfg.seed, index))``
— so the first pass can persist every converted sample and later epochs
stream raw arrays.

Storage: one append-only ``samples.bin`` holding fixed-schema flat records
(dtype+shape headers + raw bytes, written in arrival order so the writer
composes with shuffled epochs and worker pools), plus ``index.npy`` mapping
dataset index -> (offset, length) (-1 = sample is None), plus ``meta.json``
carrying a DataConfig fingerprint. Artifacts are token-named per writer
and the atomic ``meta.json`` rename is the single publish point, so an
interrupted first epoch leaves no usable cache and concurrent builders on
one root cannot corrupt each other (last publisher wins). Reads are
``np.frombuffer`` views into one mmap: no parsing, no allocation beyond the
view objects.

Edges are stored as (k, 2) int64 arrays; the collate path accepts either
lists of pairs or arrays (`dataset.py:_edges_to_adj`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import uuid
from typing import Optional

import numpy as np

from structured_alignment_vqa_tpu_torch.data.dataset import DataConfig, Sample

_MAGIC = "savqa-sample-cache-v1"

# fixed field schema: (name, dtype); `answer` rides in the record header
_FIELDS = (
    ("vis_fea", np.float32),
    ("macro_ids", np.int64),
    ("macro_edges", np.int64),
    ("obj_locs", np.int64),
    ("micro_pos_obj", np.int64),
    ("micro_neg_obj", np.int64),
    ("q_ids", np.int64),
    ("q_edges", np.int64),
)
_REL_FIELDS = (
    ("micro_pos_rel", np.int64),
    ("micro_neg_rel", np.int64),
    ("micro_pos_rel_loc", np.int64),
    ("micro_neg_rel_loc", np.int64),
)


def config_fingerprint(split: str, cfg: DataConfig) -> str:
    """Everything sample construction depends on, hashed.

    ``image_cache_size`` is a pure performance knob and is excluded; all
    other DataConfig fields change what a sample *is*.
    """
    d = dataclasses.asdict(cfg)
    d.pop("image_cache_size", None)
    d["__split__"] = split
    d["__magic__"] = _MAGIC
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _as_2col(edges) -> np.ndarray:
    a = np.asarray(edges, dtype=np.int64)
    return a.reshape(-1, 2)


def pack_sample(s: Sample) -> bytes:
    """Serialize one Sample to the flat record format."""
    has_rel = s.micro_pos_rel is not None
    arrays = [
        np.ascontiguousarray(np.asarray(s.vis_fea, np.float32)),
        np.asarray(s.macro_ids, np.int64),
        _as_2col(s.macro_edges),
        np.asarray(s.obj_locs, np.int64),
        np.asarray(s.micro_pos_obj, np.int64),
        np.asarray(s.micro_neg_obj, np.int64),
        np.asarray(s.q_ids, np.int64),
        _as_2col(s.q_edges),
    ]
    if has_rel:
        arrays += [
            np.asarray(s.micro_pos_rel, np.int64),
            np.asarray(s.micro_neg_rel, np.int64),
            np.asarray(s.micro_pos_rel_loc, np.int64).reshape(-1, 5),
            np.asarray(s.micro_neg_rel_loc, np.int64).reshape(-1, 5),
        ]
    head = [np.int64(s.answer), np.int64(1 if has_rel else 0)]
    shapes = []
    for a in arrays:
        shapes.append(np.int64(a.ndim))
        shapes.extend(np.int64(d) for d in a.shape)
    header = np.asarray(head + shapes, np.int64).tobytes()
    return (
        np.int64(len(header)).tobytes()
        + header
        + b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    )


def unpack_sample(buf, offset: int = 0) -> Sample:
    """Parse one record as zero-copy views into ``buf`` (bytes or mmap)."""
    (hlen,) = np.frombuffer(buf, np.int64, 1, offset)
    header = np.frombuffer(buf, np.int64, int(hlen) // 8, offset + 8)
    pos = offset + 8 + int(hlen)
    answer, has_rel = int(header[0]), int(header[1])
    fields = _FIELDS + (_REL_FIELDS if has_rel else ())
    hi = 2
    out = {}
    for name, dtype in fields:
        ndim = int(header[hi]); hi += 1
        shape = tuple(int(x) for x in header[hi:hi + ndim]); hi += ndim
        count = 1
        for d in shape:
            count *= d
        arr = np.frombuffer(buf, dtype, count, pos).reshape(shape)
        pos += count * np.dtype(dtype).itemsize
        out[name] = arr
    return Sample(answer=answer, **out)


class SampleCacheWriter:
    """Append-only writer; call ``add(idx, sample_or_none)`` in any order and
    ``finalize()`` once every dataset index has been seen."""

    def __init__(self, cache_dir: str, n: int, split: str, cfg: DataConfig):
        os.makedirs(cache_dir, exist_ok=True)
        self.dir = cache_dir
        self.n = n
        self.fingerprint = config_fingerprint(split, cfg)
        self.offsets = np.full(n, -1, np.int64)
        self.lengths = np.full(n, -1, np.int64)
        self.seen = np.zeros(n, bool)
        # Per-writer token: two concurrent builders (e.g. two trainer
        # processes pointed at one cache root) must never share file names —
        # a shared temp path means the second open() truncates the first's
        # bytes and the first finalize() renames a half-interleaved file into
        # place; shared *published* names race offsets-of-A against bin-of-B
        # (record order differs per shuffled epoch). Every artifact carries
        # the token and the atomic meta.json rename is the single publish
        # point: whichever writer renames last wins with a self-consistent
        # (bin, offsets) pair.
        self.token = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._tmp = os.path.join(cache_dir, f"samples-{self.token}.bin.tmp")
        self._f = open(self._tmp, "wb")
        self._pos = 0

    def add(self, idx: int, s: Optional[Sample]) -> None:
        self.seen[idx] = True
        if s is None:
            self.lengths[idx] = 0  # remembered as None (reference drop)
            return
        rec = pack_sample(s)
        self.offsets[idx] = self._pos
        self.lengths[idx] = len(rec)
        self._f.write(rec)
        self._pos += len(rec)

    @property
    def complete(self) -> bool:
        return bool(self.seen.all())

    def finalize(self) -> bool:
        """Atomically publish; returns False (and discards) if incomplete."""
        self._f.close()
        if not self.complete:
            os.unlink(self._tmp)
            return False
        os.replace(self._tmp, os.path.join(self.dir, f"samples-{self.token}.bin"))
        np.save(os.path.join(self.dir, f"offsets-{self.token}.npy"),
                np.stack([self.offsets, self.lengths]))
        meta_tmp = os.path.join(self.dir, f"meta-{self.token}.json.tmp")
        with open(meta_tmp, "w") as f:
            json.dump({"fingerprint": self.fingerprint, "n": self.n,
                       "token": self.token}, f)
        os.replace(meta_tmp, os.path.join(self.dir, "meta.json"))
        self._sweep_stale()
        return True

    def _sweep_stale(self) -> None:
        """Drop artifacts whose token lost the publish race (best-effort —
        a reader may hold a losing token's mmap open; POSIX keeps its inode
        alive until close)."""
        try:
            with open(os.path.join(self.dir, "meta.json")) as f:
                keep = json.load(f).get("token")
        except (OSError, ValueError):
            return
        for fn in os.listdir(self.dir):
            if (fn.startswith(("samples-", "offsets-")) and ".tmp" not in fn
                    and f"-{keep}." not in fn):
                try:
                    os.unlink(os.path.join(self.dir, fn))
                except OSError:
                    pass

    def abort(self) -> None:
        try:
            self._f.close()
            os.unlink(self._tmp)
        except OSError:
            pass


class SampleCache:
    """mmap-backed reader; duck-types the dataset's ``sample``/``__len__``."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        tok = self.meta["token"]
        pair = np.load(os.path.join(cache_dir, f"offsets-{tok}.npy"))
        self.offsets, self.lengths = pair[0], pair[1]
        self.buf = np.memmap(
            os.path.join(cache_dir, f"samples-{tok}.bin"), np.uint8, "r"
        )

    def __len__(self) -> int:
        return int(self.meta["n"])

    def sample(self, idx: int) -> Optional[Sample]:
        if self.lengths[idx] <= 0:
            return None
        return unpack_sample(self.buf, int(self.offsets[idx]))


def valid_cache(cache_dir: Optional[str], split: str, cfg: DataConfig) -> Optional[SampleCache]:
    """Open the cache if present and built under an identical DataConfig."""
    if not cache_dir:
        return None
    meta_fn = os.path.join(cache_dir, "meta.json")
    if not os.path.exists(meta_fn):
        return None
    try:
        cache = SampleCache(cache_dir)
    except (OSError, KeyError, ValueError):
        return None  # pre-token layout or torn/missing artifacts: rebuild
    if cache.meta.get("fingerprint") != config_fingerprint(split, cfg):
        import warnings

        warnings.warn(
            f"sample cache at {cache_dir} was built under a different "
            "DataConfig; ignoring it (delete the directory to rebuild)",
            stacklevel=2,
        )
        return None
    return cache
