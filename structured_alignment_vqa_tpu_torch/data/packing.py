"""Sequence packing: several short samples share one static-shape row (the
port's own copy of the TPU package's ``data/packing.py``, which gives the
same batches, value for value).

* each packed row carries up to ``n_pack`` samples, laid out contiguously in
  the visual, macro and question token axes;
* per-token **segment ids** (-1 on padding) isolate the samples in the
  model: every stage graph is multiplied by the segment-equality matrix, and
  the graph-guided attention multiplies by the graph before its L1 renorm,
  so the softmax normalizer cancels and keys of other segments contribute
  exactly nothing (``models/att_model_x3.py:build_stage_graphs``);
* per-token **positions** restart at every segment: a packed sample computes
  what it would compute collated alone with zero padding (*tight-bucket*
  semantics). Unpacked padded rows differ: there the reference's
  ``graph = 1 - mask`` cross stage lets valid tokens attend padding tokens;
* the decoder gets one BOS token per pack slot; ``answer`` and
  ``sample_valid`` become (B, n_pack).

Only the ``only_obj=True`` configuration packs: the relation branch's
compacted-softmax indexing runs over one sample's records.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.data.dataset import (
    LOC_PAD,
    PAD,
    BatchShape,
    Sample,
    _scatter_edges,
)

# one shared position ramp: an np.arange per sample is a hot spot of the
# collate over cached samples
_RAMP = np.arange(8192, dtype=np.int32)


@dataclasses.dataclass
class PackedRow:
    """An open row taking samples up to a BatchShape's capacity."""

    shape: BatchShape
    n_pack: int
    samples: List[Sample] = dataclasses.field(default_factory=list)
    vis_used: int = 0
    macro_used: int = 0
    q_used: int = 0

    def fits(self, s: Sample) -> bool:
        return (
            len(self.samples) < self.n_pack
            and self.vis_used + s.vis_fea.shape[0] <= self.shape.lv
            and self.macro_used + len(s.macro_ids) <= self.shape.ls
            and self.q_used + len(s.q_ids) <= self.shape.lq
        )

    def add(self, s: Sample) -> None:
        self.samples.append(s)
        self.vis_used += s.vis_fea.shape[0]
        self.macro_used += len(s.macro_ids)
        self.q_used += len(s.q_ids)


def collate_packed(
    groups: Sequence[Optional[Sequence[Sample]]],
    shape: BatchShape,
    topn: int,
    n_pack: int,
    fea_dim: int = 2048,
) -> VQABatch:
    """Pack each group of samples into one row of ``shape`` (numpy arrays).

    The caller has checked each group's capacity (``PackedRow.fits``: the
    lengths of each axis sum within the shape, at most ``n_pack`` samples);
    a None or empty group is an all-invalid row.
    """
    b = len(groups)
    lv, ls, lq = shape.lv, shape.ls, shape.lq

    vis = np.zeros((b, lv, fea_dim), np.float32)
    vis_mask = np.zeros((b, lv, lv), np.int8)
    vis_seg = np.full((b, lv), -1, np.int32)
    vis_pos = np.zeros((b, lv), np.int32)
    macro = np.full((b, ls), PAD, np.int32)
    macro_mask = np.zeros((b, ls, ls), np.int8)
    macro_graph = np.zeros((b, ls, ls), np.int8)
    macro_seg = np.full((b, ls), -1, np.int32)
    macro_pos = np.zeros((b, ls), np.int32)
    obj_loc = np.full((b, lv), LOC_PAD, np.int32)
    mpos = np.full((b, lv, topn), PAD, np.int32)
    mneg = np.full((b, lv, topn), PAD, np.int32)
    mmask = np.zeros((b, lv, topn), np.int8)
    q = np.full((b, lq), PAD, np.int32)
    q_mask = np.zeros((b, lq, lq), np.int8)
    q_graph = np.zeros((b, lq, lq), np.int8)
    q_seg = np.full((b, lq), -1, np.int32)
    q_pos = np.zeros((b, lq), np.int32)
    answer = np.zeros((b, n_pack), np.int32)
    valid = np.zeros((b, n_pack), np.int32)

    for i, group in enumerate(groups):
        if not group:
            continue
        vo = mo = qo = 0  # running offsets per axis
        for k, s in enumerate(group):
            no = s.vis_fea.shape[0]
            nm = len(s.macro_ids)
            nq = len(s.q_ids)
            vis[i, vo:vo + no] = s.vis_fea
            vis_mask[i, vo:vo + no, vo:vo + no] = 1
            vis_seg[i, vo:vo + no] = k
            vis_pos[i, vo:vo + no] = _RAMP[:no]
            macro[i, mo:mo + nm] = s.macro_ids
            macro_mask[i, mo:mo + nm, mo:mo + nm] = 1
            _scatter_edges(macro_graph[i, mo:mo + nm, mo:mo + nm], s.macro_edges, nm)
            macro_seg[i, mo:mo + nm] = k
            macro_pos[i, mo:mo + nm] = _RAMP[:nm]
            n_obj = min(len(s.obj_locs), no)
            obj_loc[i, vo:vo + n_obj] = s.obj_locs[:n_obj] + mo
            mpos[i, vo:vo + s.micro_pos_obj.shape[0]] = s.micro_pos_obj
            mneg[i, vo:vo + s.micro_neg_obj.shape[0]] = s.micro_neg_obj
            mmask[i, vo:vo + n_obj] = 1
            q[i, qo:qo + nq] = s.q_ids
            _scatter_edges(q_graph[i, qo:qo + nq, qo:qo + nq], s.q_edges, nq)
            q_mask[i, qo:qo + nq, qo:qo + nq] = 1
            q_seg[i, qo:qo + nq] = k
            q_pos[i, qo:qo + nq] = _RAMP[:nq]
            answer[i, k] = s.answer
            valid[i, k] = 1
            vo += no
            mo += nm
            qo += nq

    return VQABatch(
        vis_fea=vis,
        vis_mask=vis_mask,
        q_ipt=q,
        q_mask=q_mask,
        q_graph=q_graph,
        macro_ipt=macro,
        macro_mask=macro_mask,
        macro_graph=macro_graph,
        macro_obj_loc=obj_loc,
        micro_pos_obj=mpos,
        micro_neg_obj=mneg,
        micro_obj_mask=mmask,
        micro_pos_rel=np.full((b, 1), PAD, np.int32),
        micro_neg_rel=np.full((b, 1), PAD, np.int32),
        micro_pos_rel_loc=np.full((b, 1, 5), LOC_PAD, np.int32),
        micro_neg_rel_loc=np.full((b, 1, 5), LOC_PAD, np.int32),
        answer=answer,
        sample_valid=valid,
        vis_seg=vis_seg,
        macro_seg=macro_seg,
        q_seg=q_seg,
        vis_pos=vis_pos,
        macro_pos=macro_pos,
        q_pos=q_pos,
    )
