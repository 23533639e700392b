"""The trainer's configuration and its eval pass (counterpart of the TPU
package's ``train/loop.py``: ``TrainerConfig`` and ``run_eval``).

The training loop itself (``train``) and ``graft_glove`` are ROADMAP Queue 1
item 9 and not ported yet.
"""

from __future__ import annotations

import dataclasses
import datetime
from collections import deque
from typing import Optional

import torch

from structured_alignment_vqa_tpu_torch.data.transfer import HostFetch
from structured_alignment_vqa_tpu_torch.utils.metrics import AverageMeter

_METRICS = ("loss_sum", "mil_sum", "n_correct", "n")


@dataclasses.dataclass
class TrainerConfig:
    """The TPU package's ``TrainerConfig``, field for field, with its
    defaults. Several fields configure what the port does not run yet: the
    training loop (item 9), packing (``n_pack``, ``pack_bucket``; item 10),
    the sparse table (``sparse_table``, ``table_moments_bf16``; item 14),
    several devices (``model_parallel``; item 15); ``resident_gb`` names the
    TPU package's device-resident batches."""

    output_dir: str = "./tmp"
    batch_size: int = 32
    lr: float = 1e-4
    num_epochs: int = 40
    log_steps: int = 100
    log_steps_val: int = 100
    with_milnce: bool = True
    with_smooth_labeling: bool = True  # v3 loss always smooths (`main:334-345`)
    model_parallel: int = 1
    seed: int = 0
    resume: bool = True
    checkpoint_every: int = 1
    max_checkpoints: Optional[int] = None
    num_workers: int = 8
    num_procs: int = 0  # loader worker processes (0 = thread pool)
    n_pack: int = 1
    pack_bucket: Optional[int] = None
    # cross-epoch preprocessed-sample cache root (data/sample_cache.py); each
    # split gets its own subdirectory. None = rebuild each epoch.
    cache_dir: Optional[str] = None
    batch_replay: bool = False
    profile_steps: int = 0
    profile_start: int = 10
    eval_every: int = 1
    warmup_steps: int = 0
    sparse_table: bool = False
    table_moments_bf16: bool = False
    resident_gb: float = 8.0


def run_eval(eval_step, state, loader, logger, log_steps, tag="", metric_lag: int = 4):
    """Eval pass over device batches; returns ``(avg_loss, n_correct, n)``
    (replacing `main:380-404`).

    Each batch's metric sums start their copy to pinned host memory as soon
    as the batch is queued and are read ``metric_lag`` batches later, when
    that copy alone is waited for: reading the current batch's metrics
    would hold the host until the card has finished everything queued, and
    the next batch would not be queued meanwhile.
    """
    loss_meter = AverageMeter()
    mil_meter = AverageMeter()
    n_correct = 0.0
    n_total = 0.0
    pending: deque = deque()

    def drain(i, fetch):
        nonlocal n_correct, n_total
        loss_sum, mil_sum, correct, n = (float(v) for v in fetch.result())
        if n > 0:
            loss_meter.update(loss_sum / n, int(n))
            mil_meter.update(mil_sum / n, int(n))
        n_correct += correct
        n_total += n
        if (i + 1) % log_steps == 0:
            logger.info(
                "Time %s, %s Step [%d], Avg Loss: %s, Avg MILNCE_loss: %s",
                datetime.datetime.now(), tag, i + 1, loss_meter.avg, mil_meter.avg,
            )

    for i, batch in enumerate(loader):
        m = eval_step(state, batch)
        pending.append((i, HostFetch(torch.stack([m[k].float() for k in _METRICS]))))
        if len(pending) > metric_lag:
            drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    return loss_meter.avg, n_correct, n_total
