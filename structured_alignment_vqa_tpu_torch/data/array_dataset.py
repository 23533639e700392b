"""The legacy whole-array loader (the reference's ``dataloader/data_load*.py``
tier; the port's own copy of the TPU package's ``data/array_dataset.py``).

The earliest reference pipeline tokenized everything up front into large
padded numpy arrays: token-id sentences for the symbolic and visual
branches, one-token answers, and three staged (maxlen x maxlen) graphs per
branch (``dataloader/data_load.py:37-153``; the ``_args``/``_args_grid``
twins read argparse flags instead of a ``hyperparams`` module, and the grid
twin connects the grid features to each other). Those arrays fed the
scripts that came before the tar pipeline; the loader stays for moving
that data format. Nothing on the training or serving path imports it.

Kept from ``create_data``:

* tokens are graph-vocabulary ids; the reference's OOV fallback is the
  *string* ``'400001'`` (``de2idx.get(word, '400001')``), coerced here to
  the int 400001 (``SPECIALS.UNK``);
* samples longer than ``maxlen``, or with no region features, are skipped;
* stage graphs: G1 = the cross-modality blocks plus the explicit edges,
  G2 = the cross blocks only, G3 = the question-question block; the visual
  ones are offset by the region count, and ``grid_self_connect`` also sets
  the visual-visual block (the grid twin's one-line difference).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from structured_alignment_vqa_tpu_torch.models.glove import SPECIALS

PAD = SPECIALS.PAD
UNK = SPECIALS.UNK


@dataclasses.dataclass
class ArrayBundle:
    X_syb: np.ndarray   # (N, maxlen) int32
    X_vis: np.ndarray   # (N, maxlen) int32
    Y: np.ndarray       # (N, 1) int32
    G_syb: Tuple[np.ndarray, np.ndarray, np.ndarray]
    G_vis: Tuple[np.ndarray, np.ndarray, np.ndarray]
    X0: List[np.ndarray]  # per-sample region features


def create_arrays(
    sents_syb: Sequence[str],
    sents_vis: Sequence[str],
    answers: Sequence[str],
    edges_syb: Sequence[Sequence],
    edges_vis: Sequence[Sequence],
    region_feats: Sequence[np.ndarray],
    q_lengths: Sequence[int],
    de2idx: dict,
    en2idx: dict,
    maxlen: int,
    grid_self_connect: bool = False,
) -> ArrayBundle:
    xs, xv, ys, gs, gv, x0s, qs = [], [], [], [], [], [], []
    for s_syb, s_vis, ans, g_syb, g_vis, feat, q_id in zip(
        sents_syb, sents_vis, answers, edges_syb, edges_vis, region_feats, q_lengths
    ):
        x_syb = [int(de2idx.get(w, UNK)) for w in (s_syb + " </s>").split()]
        x_vis = [int(de2idx.get(w, UNK)) for w in (s_vis + " </s>").split()]
        y = [en2idx.get(ans, 1)]
        if len(x_syb) <= maxlen and feat.shape[0] != 0:
            xs.append(np.asarray(x_syb))
            xv.append(np.asarray(x_vis))
            ys.append(np.asarray(y))
            gs.append(np.asarray(g_syb))
            gv.append(np.asarray(g_vis))
            x0s.append(feat)
            qs.append(q_id + 1)

    n = len(xs)
    X_syb = np.full((n, maxlen), PAD, np.int32)
    X_vis = np.full((n, maxlen), PAD, np.int32)
    Y = np.zeros((n, 1), np.int32)
    G_syb = [np.zeros((n, maxlen, maxlen), np.int8) for _ in range(3)]
    G_vis = [np.zeros((n, maxlen, maxlen), np.int8) for _ in range(3)]

    for i, (x_syb, x_vis, y, g_syb, g_vis, x0, q_len) in enumerate(
        zip(xs, xv, ys, gs, gv, x0s, qs)
    ):
        X_syb[i, : len(x_syb)] = x_syb
        nv0 = x0.shape[0]
        X_vis[i, nv0: nv0 + len(x_vis)] = x_vis
        Y[i] = y

        ls, q = len(x_syb), q_len
        # symbolic: the cross blocks between the graph part [0, ls-q) and
        # the question [ls-q, ls)
        G_syb[0][i, : ls - q, ls - q: ls] = 1
        G_syb[0][i, ls - q: ls, : ls - q] = 1
        G_syb[1][i, : ls - q, ls - q: ls] = 1
        G_syb[1][i, ls - q: ls, : ls - q] = 1
        G_syb[2][i, ls - q: ls, ls - q: ls] = 1

        lv = len(x_vis)
        G_vis[0][i, :nv0, nv0: nv0 + lv] = 1
        G_vis[0][i, nv0: nv0 + lv, :nv0] = 1
        G_vis[1][i, :nv0, nv0: nv0 + lv] = 1
        G_vis[1][i, nv0: nv0 + lv, :nv0] = 1
        G_vis[2][i, nv0: nv0 + lv, nv0: nv0 + lv] = 1
        if grid_self_connect:  # data_load_args_grid.py:100
            G_vis[2][i, :nv0, :nv0] = 1

        for e in np.asarray(g_syb).reshape(-1, 2) if len(g_syb) else []:
            if e[0] < maxlen and e[1] < maxlen:
                G_syb[0][i, e[0], e[1]] = 1
        for e in np.asarray(g_vis).reshape(-1, 2) if len(g_vis) else []:
            if e[0] < maxlen and e[1] < maxlen:
                G_vis[0][i, e[0], e[1]] = 1

    return ArrayBundle(X_syb, X_vis, Y, tuple(G_syb), tuple(G_vis), x0s)


def get_batch_indices(
    total_length: int, batch_size: int, seed: Optional[int] = None
) -> Iterator[Tuple[List[int], int]]:
    """Shuffled batch indices (``data_load.py:155-163``), from an explicit
    seed instead of the global random state. The reference's off-by-one is
    kept: it advances before it yields, so the first ``batch_size`` shuffled
    indices are never given and the last slice may be short."""
    rng = np.random.default_rng(seed)
    idx = list(range(total_length))
    rng.shuffle(idx)
    current = 0
    while True:
        if current + batch_size >= total_length:
            break
        current += batch_size
        yield idx[current: current + batch_size], current
