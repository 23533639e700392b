"""The batch (counterpart of the TPU package's ``data/batch.py``).

Field for field the reference collate outputs. ``sample_valid`` replaces the
reference's collate-time None-filtering so the batch dimension is fixed.

On the host, where ``data/dataset.py:collate`` and the caches make it, a
batch holds numpy arrays. ``data/transfer.py`` moves it to the device as
torch tensors in the dtypes collate gives, so these arrive:

* ``vis_fea``: float32, or bfloat16 when the model computes in bfloat16
  (the model casts it to the compute dtype at both of its uses, so the
  result is the same and half the bytes travel);
* masks and graphs (``vis_mask``, ``q_mask``, ``q_graph``, ``macro_mask``,
  ``macro_graph``, ``micro_obj_mask``): int8, 0/1;
* ids, locations, ``answer`` and ``sample_valid``: int32;
* on a packed batch (``data/packing.py``), the segment ids and positions:
  int32, and ``answer`` and ``sample_valid`` are (B, n_pack).

The model widens on the device only where an op needs it: masks to float32
where the stage graphs are built, ``answer`` to int64 for ``one_hot``.
Synthetic batches (``data/synthetic.py``) hold int64 ids and int32 masks;
the model takes either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class VQABatch:
    vis_fea: torch.Tensor        # (B, Lv, 2048) float  — region features
    vis_mask: torch.Tensor       # (B, Lv, Lv) 0/1
    q_ipt: torch.Tensor          # (B, Lq) int          — GloVe vocab ids
    q_mask: torch.Tensor         # (B, Lq, Lq) 0/1
    q_graph: torch.Tensor        # (B, Lq, Lq) 0/1      — word-node adjacency
    macro_ipt: torch.Tensor      # (B, Ls) int          — super/attr/pos/rel node ids
    macro_mask: torch.Tensor     # (B, Ls, Ls) 0/1
    macro_graph: torch.Tensor    # (B, Ls, Ls) 0/1      — scene-graph adjacency
    macro_obj_loc: torch.Tensor  # (B, O) int           — object slot -> macro row, -1 pad
    micro_pos_obj: torch.Tensor  # (B, O, topN) int
    micro_neg_obj: torch.Tensor  # (B, O, topN) int
    micro_obj_mask: torch.Tensor  # (B, O, topN) 0/1
    micro_pos_rel: torch.Tensor   # (B, R) int
    micro_neg_rel: torch.Tensor   # (B, R) int
    micro_pos_rel_loc: torch.Tensor  # (B, R, 5) int
    micro_neg_rel_loc: torch.Tensor  # (B, R, 5) int
    answer: torch.Tensor         # (B,) or (B, K) int — 0 = out-of-vocab answer
    sample_valid: torch.Tensor   # 0/1

    # sequence packing (data/packing.py; None on unpacked batches): per-token
    # segment ids (-1 on padding) and per-segment positions
    vis_seg: Optional[torch.Tensor] = None
    macro_seg: Optional[torch.Tensor] = None
    q_seg: Optional[torch.Tensor] = None
    vis_pos: Optional[torch.Tensor] = None
    macro_pos: Optional[torch.Tensor] = None
    q_pos: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.vis_fea.shape[0]

    @property
    def n_pack(self) -> int:
        """Pack slots per row (1 = unpacked)."""
        return 1 if self.answer.ndim == 1 else self.answer.shape[1]

    def to(self, device, non_blocking: bool = False) -> "VQABatch":
        moved = {
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device, non_blocking=non_blocking))
            for f in dataclasses.fields(self)
        }
        return VQABatch(**moved)
