"""Attention-MIL margin ranking loss (counterpart of the TPU package's
``train/att_mil_loss.py``).

The reference's ``ATTMILLoss``, vectorised: for each (block, sample, valid
object slot) it compares the attention mass a visual row puts on the scene
graph's *neighbour* columns of the slot's node with the mass on the other
columns, under the hinge ``max(0, neg - pos + margin)``, margin 0.6.

Reference quirks kept:

* only head 0 feeds the loss (the reference indexes its head-major
  ``(H*B, Tq, Tk)`` tensor by sample id);
* the attention row is the object slot's *position*, not its node's row;
* the mean runs over ``blocks * B * Ls`` slots, and each slot no object
  fills adds ``margin`` (a (0, 0) pair of the reference's preallocated
  buffer).
"""

from __future__ import annotations

from typing import Sequence

import torch


def att_mil_loss(att_weights: Sequence[torch.Tensor], idx_of_obj: torch.Tensor,
                 syb_graph: torch.Tensor, margin: float = 0.6) -> torch.Tensor:
    """att_weights: each (B, H, Tq, Ls); idx_of_obj (B, O), the node row of
    each object slot, -1 on padding; syb_graph (B, Ls, Ls). Returns a
    float32 scalar."""
    b, ls = syb_graph.shape[:2]
    o = idx_of_obj.shape[1]
    valid = idx_of_obj >= 0                                          # (B, O)
    safe = idx_of_obj.clamp(0, ls - 1).long()
    neigh = (torch.gather(syb_graph, 1, safe[..., None].expand(b, o, ls)) > 0).float()
    total = torch.zeros((), dtype=torch.float32, device=syb_graph.device)
    for att in att_weights:
        rows = att[:, 0, :o, :].float()                              # head 0, slot rows
        pos = (rows * neigh).sum(dim=-1)
        neg = (rows * (1.0 - neigh)).sum(dim=-1)
        hinge = torch.clamp_min(neg - pos + margin, 0.0)
        total = total + torch.where(valid, hinge, torch.zeros_like(hinge)).sum()
    denom = len(att_weights) * b * ls
    unfilled = denom - len(att_weights) * valid.float().sum()
    return (total + unfilled * margin) / denom
