"""MIL-NCE math for the object and relation branches (counterpart of the TPU
package's ``ops/mil_nce.py``).

The reference gathers only the *valid* candidate scores into ragged vectors
and runs logsumexp and softmax over them. As in the TPU package, every slot
is kept and invalid ones are masked to -inf, which is the same because
exp(-inf) = 0; so shapes do not depend on the data.

Under a mesh of several ranks (``parallel/context.py``) each function works
on the global batch, as the TPU package's global-batch step does: the
object term's mean runs over every rank's (B, O) and each rank returns its
share; the relation functions take the scores the model gathered from
every rank in rank order (``models/att_model_x3.py``).
"""

from __future__ import annotations

import torch

from structured_alignment_vqa_tpu_torch.parallel.context import distributed_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import gather_scores, host_sum

# Scores are clamped at this floor before logsumexp (reference ``.clamp(min=eps)``).
MIL_EPS = 1e-6


def masked_logsumexp(x: torch.Tensor, valid: torch.Tensor, dim=None) -> torch.Tensor:
    """logsumexp over ``dim`` (all axes if None) counting only ``valid`` entries."""
    masked = torch.where(valid, x, torch.full_like(x, -torch.inf))
    if dim is None:
        return torch.logsumexp(masked.reshape(-1), dim=0)
    return torch.logsumexp(masked, dim=dim)


def mil_nce_obj_objective(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    """Object-branch MIL-NCE (reference ``AttModel_x3.py:365-367``).

    ``pos_scores``/``neg_scores``: (B, O, topN), already multiplied by the
    object validity mask. Everything (masked zeros included) is clamped at
    eps; the numerator logsumexps the positives beside an all-eps block, the
    denominator beside the negatives, along the object axis, over topN; the
    result is the global mean of their difference; under a mesh of several
    ranks, this rank's share of it (its sum over the global count).
    """
    pos_c = pos_scores.float().clamp_min(MIL_EPS)
    neg_c = neg_scores.float().clamp_min(MIL_EPS)
    eps_block = torch.full_like(neg_c, MIL_EPS)
    numerator = torch.logsumexp(torch.cat([pos_c, eps_block], dim=1), dim=2)
    denominator = torch.logsumexp(torch.cat([pos_c, neg_c], dim=1), dim=2)
    diff = numerator - denominator
    mesh = distributed_mesh()
    if mesh is None:
        return diff.mean()
    return diff.sum() / host_sum([diff.numel()], mesh)[0]


def mil_nce_rel_objective(pos_scores: torch.Tensor, pos_valid: torch.Tensor,
                          neg_scores: torch.Tensor, neg_valid: torch.Tensor) -> torch.Tensor:
    """Relation-branch MIL-NCE (reference ``AttModel_x3.py:403-414``).

    ``pos_scores``/``neg_scores``: flattened (B*R,) gathered bilinear scores;
    ``pos_valid``/``neg_valid``: matching booleans (loc >= 0 slots). Returns
    ``logsumexp(valid pos) - logsumexp(valid pos U valid neg)`` with each
    valid score clamped at eps. With no valid record at all both terms are
    -inf and the result is NaN while its gradient is zero (invalid slots are
    selected away), as in the TPU package: such a batch logs a NaN loss and
    still takes its step from the other terms.
    """
    pos_c = pos_scores.float().clamp_min(MIL_EPS)
    neg_c = neg_scores.float().clamp_min(MIL_EPS)
    lse_pos = masked_logsumexp(pos_c, pos_valid)
    lse_all = masked_logsumexp(torch.cat([pos_c, neg_c]), torch.cat([pos_valid, neg_valid]))
    return lse_pos - lse_all


def compact_softmax_gather(scores: torch.Tensor, valid: torch.Tensor,
                           gather_idx: torch.Tensor) -> torch.Tensor:
    """Softmax over the compacted valid scores, then a lookup by raw index
    (reference ``AttModel_x3.py:420-427``).

    The reference builds the vector of valid positive scores in batch-major
    order, softmaxes it over *all* positives of the batch jointly, and reads
    entry ``micro_rel_loc`` of that compacted vector for each positive.

    ``scores`` (M,) raw scores in batch-major flattening, ``valid`` (M,)
    booleans, ``gather_idx`` indices into the compacted vector (the same
    length, or under a mesh this rank's slots of the global ``scores``).
    Returns float32 weights shaped as ``gather_idx``; an index outside
    [0, M) or beyond the number of valid entries gives 0.
    """
    m = scores.shape[0]
    clamped = scores.float().clamp_min(MIL_EPS)
    sm = torch.softmax(torch.where(valid, clamped, torch.full_like(clamped, -torch.inf)), dim=0)
    ranks = torch.cumsum(valid.long(), dim=0) - 1
    # invalid slots go to a spare slot m that is cut off; each valid slot
    # has its own rank, so no two writes meet and the order cannot matter
    scatter_to = torch.where(valid, ranks, torch.full_like(ranks, m))
    compact = torch.zeros(m + 1, dtype=sm.dtype, device=sm.device).scatter(0, scatter_to, sm)[:m]
    in_range = (gather_idx >= 0) & (gather_idx < m)
    out = compact[gather_idx.clamp(0, m - 1)]
    return torch.where(in_range, out, torch.zeros_like(out))
