"""Vocabulary loading (graph-node vocab TSV + answer vocab): the port's own
copy of the TPU package's ``data/vocab.py``.

Equivalent of `data_loader_itp_bbox_super_node_onlyobj.py:20-32`:

* graph vocab file: ``word index`` lines -> {word: index} both ways,
* answer vocab file: ``answer count`` lines; answers with count >= min_cnt get
  ids 1..K (id 0 is the "all other" class); ``num_classes = K + 1``.
"""

from __future__ import annotations

import codecs
from typing import Dict, Tuple


def load_graph_vocab(path: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    word2idx: Dict[str, int] = {}
    idx2word: Dict[int, str] = {}
    with codecs.open(path, "r", "utf-8") as f:
        for line in f.read().splitlines():
            parts = line.split()
            if len(parts) < 2:
                continue
            word, idx = parts[0], int(parts[1])
            word2idx[word] = idx
            idx2word[idx] = word
    return word2idx, idx2word


def load_answer_vocab(path: str, min_cnt: int) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Answers seen >= min_cnt times, ids starting at 1 (0 = out-of-vocab)."""
    word2idx: Dict[str, int] = {}
    idx2word: Dict[int, str] = {}
    next_id = 1
    with codecs.open(path, "r", "utf-8") as f:
        for line in f.read().splitlines():
            parts = line.split()
            if len(parts) < 2:
                continue
            word = " ".join(parts[:-1])
            if int(parts[-1]) >= min_cnt:
                word2idx[word] = next_id
                idx2word[next_id] = word
                next_id += 1
    return word2idx, idx2word


def load_object_vocab(path: str) -> list[str]:
    """Visual-genome class list: first comma field, lowercased/stripped
    (`data_loader_itp_bbox_super_node_onlyobj.py:81-92`)."""
    out = []
    with open(path) as f:
        for line in f.readlines():
            out.append(line.split(",")[0].lower().strip())
    return out
