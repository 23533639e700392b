"""Training objectives (counterpart of the TPU package's ``train/losses.py``).

The v3 training loss (reference ``main_itp_ddp_tar_super_node.py:334-360``):
average the log-softmaxes of the three classifier heads, cross-entropy
against the label-smoothed one-hot answer, plus the negated MIL-NCE terms.

Invalid samples stay in the batch with ``sample_valid=0``; the mean runs
over the valid ones, floored at 1. Under a mesh of several ranks
(``parallel/context.py``) the mean is over the *global* batch, as in the
TPU package's global-batch step: each rank returns its share, its own
samples' sum over the global count of valid samples, and the shares sum
over the ranks to the global loss and, through the backward, to its
gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from structured_alignment_vqa_tpu_torch.ops.layers import label_smoothing
from structured_alignment_vqa_tpu_torch.parallel.context import distributed_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import all_reduce_sum


def ensemble_log_softmax(logits_concat, logits_vis, logits_syb) -> torch.Tensor:
    """Mean of the three heads' log-softmaxes, in float32 (``main:335-339``)."""
    return (F.log_softmax(logits_vis.float(), dim=-1)
            + F.log_softmax(logits_syb.float(), dim=-1)
            + F.log_softmax(logits_concat.float(), dim=-1)) / 3.0


def ensemble_smoothed_ce(logits_concat, logits_vis, logits_syb, answer, sample_valid,
                         smooth_eps: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean loss over valid samples, per-sample ensemble log-softmax);
    under a mesh of several ranks the loss is this rank's share of the
    global mean."""
    log_sm = ensemble_log_softmax(logits_concat, logits_vis, logits_syb)
    one_hot = F.one_hot(answer.long(), log_sm.shape[-1]).float()
    per_sample = -(label_smoothing(one_hot, smooth_eps) * log_sm).sum(dim=-1)
    valid = sample_valid.float()
    count = valid.sum()
    mesh = distributed_mesh()
    if mesh is not None:
        count = all_reduce_sum(count, mesh)
    loss = (per_sample * valid).sum() / count.clamp_min(1.0)
    return loss, log_sm


def mil_nce_loss(mil_obj: torch.Tensor, mil_rel: torch.Tensor, only_obj: bool) -> torch.Tensor:
    """``-mil_nce_obj [- mil_nce_rel]`` (``main:326-329``)."""
    loss = -mil_obj
    if not only_obj:
        loss = loss - mil_rel
    return loss


def batch_metrics(log_sm: torch.Tensor, answer: torch.Tensor, sample_valid: torch.Tensor):
    """``(n_correct, n)``, reference-style: only samples whose answer is in
    the answer vocabulary (answer != 0) can count as correct
    (``main:125-126``), but ``n`` counts every valid sample, as the
    reference's ``cnt += batch_size`` does."""
    pred = torch.argmax(log_sm, dim=-1)
    valid = sample_valid.float()
    in_vocab = (answer != 0).float() * valid
    n_correct = ((pred == answer).float() * in_vocab).sum()
    return n_correct, valid.sum()
