"""GloVe-backed vocabulary table construction: the port's own copy of the
TPU package's ``models/glove.py`` (numpy; the table stays numpy until a
driver copies it into the model).

The reference builds a 407,000 x 300 xavier-random table and copies GloVe
6B-300d vectors into rows [0, 400000) (`AttModel_x3.py:36-38,168-170,293-295`
via torchtext). Here the table accepts any of:

* a ``glove.6B.300d.txt``-format text file,
* a pre-converted ``.npy`` matrix (rows in vocab order),
* nothing — rows stay xavier-random (fine for tests/benchmarks; training from
  scratch merely loses the warm start).

Special ids (`AttModel_x3.py:13-18`): PAD=400000, UNK=400001, END=INVALID=400003.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpecialIds:
    PAD: int = 400000
    UNK: int = 400001
    END: int = 400003
    INVALID: int = 400003
    VIS_PAD: int = -1
    LOC_PAD: int = -1


SPECIALS = SpecialIds()


def xavier_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Xavier/Glorot normal, matching ``nn.init.xavier_normal_`` semantics."""
    fan_in, fan_out = shape[-1], shape[-2]
    std = float(np.sqrt(2.0 / (fan_in + fan_out)))
    return rng.standard_normal(shape).astype(np.float32) * std


def load_glove_vectors(path: str, dim: int) -> tuple[list[str], np.ndarray]:
    """Parse a GloVe text file into (words, vectors)."""
    words, vecs = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            words.append(parts[0])
            vecs.append(np.asarray(parts[1:], dtype=np.float32))
    return words, np.stack(vecs) if vecs else np.zeros((0, dim), np.float32)


def build_glove_table(
    vocab_size: int = 407000,
    dim: int = 300,
    glove_path: Optional[str] = None,
    seed: int = 0,
) -> np.ndarray:
    """(vocab_size, dim) float32 table: xavier-random with GloVe rows grafted in.

    ``glove_path`` may be a ``.npy`` matrix or a GloVe ``.txt``; ``None`` or a
    missing file yields the pure-random table.
    """
    rng = np.random.default_rng(seed)
    table = xavier_normal(rng, (vocab_size, dim))
    if glove_path and os.path.exists(glove_path):
        if glove_path.endswith(".npy"):
            vectors = np.load(glove_path).astype(np.float32)
        else:
            _, vectors = load_glove_vectors(glove_path, dim)
        n = min(vectors.shape[0], vocab_size)
        table[:n] = vectors[:n]
    return table
