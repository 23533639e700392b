"""Metric helpers (reference: `models/misc.py`): the port's own copy of the
TPU package's ``utils/metrics.py``."""

from __future__ import annotations

import errno
import os

import numpy as np


class AverageMeter:
    """Running average with weighted updates (`misc.py:46-63`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def precision_top_k(logits: np.ndarray, target: np.ndarray, top_k=(1,)):
    """Precision@k over a batch (`misc.py:21-34`), framework-free."""
    maxk = max(top_k)
    batch = target.shape[0]
    top = np.argsort(-logits, axis=1)[:, :maxk]  # (B, maxk)
    correct = top == target[:, None]
    return [float(correct[:, :k].sum()) * 100.0 / batch for k in top_k]


def mkdir_p(path: str):
    """mkdir -p (`misc.py:36-44`)."""
    try:
        os.makedirs(path)
    except OSError as exc:
        if not (exc.errno == errno.EEXIST and os.path.isdir(path)):
            raise
