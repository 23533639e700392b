"""AttModelX3, obj-only and obj+rel, packed or not (counterpart of the TPU
package's ``models/att_model_x3.py``).

* ``VisualEncoder``   <- reference ``AttModel_vis_grid``
* ``SymbolicEncoder`` <- reference ``AttModel_syb``
* ``MILNCEModule``    <- reference ``MIL_NCE`` (object and relation branches)
* ``AttModelX3``      <- reference ``AttModel`` with the concat head or,
  with ``use_mcb``, the MCB head (``ops/mcb.py``)

A packed batch (``data/packing.py``) carries segment ids and positions:
the stage graphs isolate its samples, the positions restart per sample,
and the decoder runs one token per pack slot, so the logits are
(B, n_pack, C) instead of (B, C).

Modules carry the reference's torch state-dict names
(``att_vis_grid.enc_self_attention_0.Q_proj.0.weight``, ``cls.3.weight``,
...), so ``models/convert.py`` output and the TPU package's
``export_state_dict(..., ddp_prefix=False)`` load with ``strict=True``.
Parameters the reference defines but its forward never reads are omitted.

Under a mesh of several ranks (``parallel/context.py``) the model computes
what the TPU package's step computes on the global batch: the relation
branch's objective and joint softmax run over every rank's records, the
MCB norm over every rank's rows, and ``mil_obj``/``mil_rel`` are this
rank's shares of the global terms (they sum over the ranks to them).

On the model axis (``parallel/sharding.py:shard_model``) each split layer
computes its shard and the model row's collectives make it whole
(``ops/layers.py``); two pairs stay split between their layers, as
Megatron pairs a column-split layer with a row-split one: each branch's
``syb_mlp`` into its ``syb_mlp2``, and ``MIL_NCE.ipt_mlp`` into the
symbolic branch's ``syb_mlp2`` (:func:`link_model_splits`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.device import resolve_device
from structured_alignment_vqa_tpu_torch.models.config import ModelConfig
from structured_alignment_vqa_tpu_torch.ops.attention import (
    GraphGuidedAttention,
    MultiHeadAttention,
)
from structured_alignment_vqa_tpu_torch.ops.layers import (
    Dropout,
    Embedding,
    FeedForward,
    Linear,
    dense_relu,
    linear_relu,
)
from structured_alignment_vqa_tpu_torch.ops.mcb import (
    compact_bilinear_pooling,
    count_sketch_matrix,
)
from structured_alignment_vqa_tpu_torch.ops.mil_nce import (
    compact_softmax_gather,
    mil_nce_obj_objective,
    mil_nce_rel_objective,
)
from structured_alignment_vqa_tpu_torch.ops.quant import QDense, quantized_lookup
from structured_alignment_vqa_tpu_torch.parallel.context import distributed_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    gather_rows,
    gather_scores,
    scatter_columns,
    vocab_lookup,
)

BOS_ID = 2  # decoder input token
# the generator the MCB head's frozen count sketches are drawn from: the TPU
# package's ``AttModelX3.mcb_sketch_seed``, so both hold the same sketches
MCB_SKETCH_SEED = 12345


def build_stage_graphs(
    modality_mask: torch.Tensor,
    q_mask: torch.Tensor,
    q_graph: torch.Tensor,
    modality_graph: Optional[torch.Tensor],
    use_dec_mask: bool,
    distinct_cross_stage: bool = False,
    mod_seg: Optional[torch.Tensor] = None,
    q_seg: Optional[torch.Tensor] = None,
    n_pack: int = 1,
):
    """Staged graphs over (modality ++ question) tokens.

    Returns ``(graph_diag, graph_cross, graph, dec_mask)``, float32;
    ``dec_mask`` is (B, n_pack, Lm+Lq), one row per decoder token.
    ``modality_graph=None`` means fully connected (the visual branch). By
    default ``graph_cross`` *is* ``graph``, replicating the reference's
    in-place aliasing.

    ``mod_seg``/``q_seg``: (B, Lm)/(B, Lq) pack-segment ids of a packed row
    (-1 on padding). Every stage graph is then multiplied by the
    segment-equality matrix, and decoder slot k sees segment k's tokens
    only: the attention multiplies by the graph before its L1 renorm, so
    the keys of other segments contribute exactly nothing.
    """
    b, lm, _ = modality_mask.shape
    lq = q_mask.shape[1]
    size = lm + lq
    f32 = torch.float32
    dev = modality_mask.device

    mask = torch.zeros(b, size, size, dtype=f32, device=dev)
    mask[:, :lm, :lm] = modality_mask.to(f32)
    mask[:, lm:, lm:] = q_mask.to(f32)

    # stage 1: the reference writes only the question block
    graph_diag = torch.zeros(b, size, size, dtype=f32, device=dev)
    graph_diag[:, lm:, lm:] = q_mask.to(f32)

    graph = 1.0 - mask
    graph[:, :lm, :lm] = 1.0 if modality_graph is None else modality_graph.to(f32)
    graph[:, lm:, lm:] = q_graph.to(f32)

    graph_cross = (1.0 - mask) if distinct_cross_stage else graph

    seg = None
    if mod_seg is not None:
        seg = torch.cat([mod_seg, q_seg], dim=1)                     # (B, size)
        seg_eq = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0)).to(f32)
        graph_diag = graph_diag * seg_eq
        graph = graph * seg_eq
        graph_cross = graph_cross * seg_eq if distinct_cross_stage else graph

    valid = (mask.sum(dim=2) > 0).to(f32)
    if not use_dec_mask:
        dec_mask = torch.zeros(b, n_pack, size, dtype=f32, device=dev)
    elif seg is None:
        dec_mask = valid[:, None, :].expand(b, n_pack, size)
    else:
        slots = torch.arange(n_pack, device=dev)[None, :, None]     # (1, K, 1)
        dec_mask = (seg[:, None, :] == slots).to(f32) * valid[:, None, :]
    return graph_diag, graph_cross, graph, dec_mask


class GloVeEmbed(nn.Module):
    """Trainable GloVe lookup (parameter ``weight``, no zero row, no scale):
    gather, then cast to the compute dtype.

    ``quantized``: the int8 serving layout (``ops/quant.py``), buffers
    ``weight_q`` int8 (vocab, dim) and ``weight_scale`` float32 (vocab,);
    only the gathered rows are dequantized. Split over the model axis by
    vocab rows (both int8 buffers alike), each rank looks up the ids of its
    rows and the model row sums them (``parallel/sharding.py:vocab_lookup``)."""

    model_split = None

    def __init__(self, vocab_size: int, dim: int, dtype: torch.dtype = torch.float32,
                 device=None, quantized: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.quantized = quantized
        if quantized:
            self.register_buffer("weight_q", torch.zeros(vocab_size, dim, dtype=torch.int8,
                                                         device=device))
            self.register_buffer("weight_scale", torch.ones(vocab_size, device=device))
            return
        self.weight = nn.Parameter(torch.empty(vocab_size, dim, device=device))
        nn.init.xavier_normal_(self.weight)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.quantized:
            def lookup(i):
                return quantized_lookup(self.weight_q, self.weight_scale, i, dt)
        else:
            def lookup(i):
                return nn.functional.embedding(i, self.weight)
        out = lookup(ids) if self.model_split is None else vocab_lookup(ids, self.model_split,
                                                                         lookup)
        return out.to(dt)


class _Branch(nn.Module):
    """One encoder/decoder branch: three attention stages over (modality ++
    question) tokens, then a decoder of one token per pack slot (one on an
    unpacked row) cross-attending into them.

    The ablation variants (``models/variants.py``) set the TPU package's two
    knobs of ``_EncoderDecoder``: ``mlp_relu=False`` makes the question
    projection a bare Linear (the x2_dec line), ``dec_cross="vanilla"``
    makes the decoder's cross-attention content-masked multi-head attention
    with no dec_mask (x2_mlp_dec). Two more carry the reference forks'
    parameter names: ``mlp_name`` names the question projection, and
    ``pe_sequential`` says whether the positional table sits in a
    Sequential (``syb_positional_encoding.0``), as it does by default
    exactly when its output is dropped out.

    ``modality_local``: on the model axis, the modality features arrive as
    this rank's columns (``MIL_NCE.ipt_mlp``'s, :func:`link_model_splits`)."""

    modality_local = False

    def __init__(self, cfg: ModelConfig, pe_table_size: int, pe_dropout: bool,
                 glove: Optional[GloVeEmbed], device=None, mlp_relu: bool = True,
                 dec_cross: str = "graph", mlp_name: str = "syb_mlp",
                 pe_sequential: Optional[bool] = None):
        super().__init__()
        if dec_cross not in ("graph", "vanilla"):
            raise ValueError(f"unknown dec_cross {dec_cross!r}")
        dt = cfg.compute_dtype
        h = cfg.hidden_size
        self.cfg = cfg
        self.syb_emb = (glove if glove is not None
                        else GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, device,
                                        cfg.int8_serving))
        self.mlp_name = mlp_name
        self.add_module(mlp_name, linear_relu(cfg.glove_dim, cfg.vis_fea_dim, dt, device)
                        if mlp_relu else Linear(cfg.glove_dim, cfg.vis_fea_dim, dt, device))
        self.syb_mlp2 = Linear(cfg.vis_fea_dim, h, dt, device)
        pe = Embedding(pe_table_size, h, zeros_pad=False, scale=False, dtype=dt, device=device)
        self.syb_positional_encoding = (
            nn.Sequential(pe) if (pe_dropout if pe_sequential is None else pe_sequential) else pe
        )
        self.pe_dropout = Dropout(cfg.dropout_rate) if pe_dropout else None
        self.fea_dropout = Dropout(cfg.dropout_rate)
        self.dec_cross = dec_cross
        for i in range(cfg.num_blocks):
            self.add_module(f"enc_self_attention_{i}", GraphGuidedAttention(
                h, cfg.num_heads, dtype=dt, device=device, seq_axis=cfg.seq_axis,
                seq_impl=cfg.seq_impl))
            self.add_module(f"enc_feed_forward_{i}", FeedForward(h, (4 * h, h), dt, device))
        self.dec_emb = Embedding(cfg.num_classes, h, zeros_pad=True, scale=True, dtype=dt,
                                 device=device)
        self.dec_positional_encoding = Embedding(pe_table_size, h, zeros_pad=False,
                                                 scale=False, dtype=dt, device=device)
        self.dec_dropout = Dropout(cfg.dropout_rate)
        for i in range(cfg.num_blocks):
            self.add_module(f"dec_self_attention_{i}", MultiHeadAttention(
                h, cfg.num_heads, causality=True, dtype=dt, device=device))
            cross = GraphGuidedAttention if dec_cross == "graph" else MultiHeadAttention
            self.add_module(f"dec_vanilla_attention_{i}", cross(
                h, cfg.num_heads, dtype=dt, device=device))
            self.add_module(f"dec_feed_forward_{i}", FeedForward(h, (4 * h, h), dt, device))

    def _project(self, modality_fea, q_emb):
        """``syb_mlp2`` of (modality features ++ the question's ``syb_mlp``
        features). With ``syb_mlp2`` row-split on the model axis both parts
        enter as this rank's columns: the question's straight from a
        column-split ``syb_mlp``, no collective between the two layers."""
        mlp = getattr(self, self.mlp_name)
        split = self.syb_mlp2.model_split
        if split is None or split.dim != 1:
            return self.syb_mlp2(torch.cat([modality_fea, mlp(q_emb)], dim=1))
        lin = mlp[0] if isinstance(mlp, nn.Sequential) else mlp
        if lin.model_split is not None and lin.model_split.dim == 0:
            q_fea = dense_relu(mlp, q_emb, local_out=True)
        else:
            q_fea = scatter_columns(mlp(q_emb), split.mesh)
        if not self.modality_local:
            modality_fea = scatter_columns(modality_fea, split.mesh)
        return self.syb_mlp2(torch.cat([modality_fea, q_fea], dim=1), local_in=True)

    def _enc_block(self, i: int, fea, graph):
        """Encoder block ``i``: graph-guided self-attention, then the FFN.
        It draws no dropout mask, so recomputing it replays no generator."""
        fea = getattr(self, f"enc_self_attention_{i}")(fea, fea, fea, graph)
        return getattr(self, f"enc_feed_forward_{i}")(fea)

    def forward(self, modality_fea, modality_mask, modality_graph, q_ids, q_graph, q_mask,
                generator: Optional[torch.Generator] = None, mod_seg=None, q_seg=None,
                mod_pos=None, q_pos=None, n_pack: int = 1):
        """Returns (B, n_pack, hidden). The packing arguments (segment ids
        and positions of the modality and question tokens) come from a
        packed batch; ``None`` on an unpacked one."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b = modality_fea.shape[0]
        h = cfg.hidden_size

        fea = self._project(modality_fea.to(dt), self.syb_emb(q_ids))
        size = fea.shape[1]
        if mod_pos is None:
            pos_ids = torch.arange(size, device=fea.device).expand(b, size)
        else:
            # tight-bucket positions: a packed sample sees the ids it would
            # see collated alone, its question offset by its OWN modality
            # token count (counted from the segment ids), not the row's
            mod_count = ((mod_seg[:, None, :] == q_seg[:, :, None])
                         & (mod_seg[:, None, :] >= 0)).sum(dim=-1)     # (B, Lq)
            pos_ids = torch.cat([mod_pos, q_pos + mod_count.to(q_pos.dtype)], dim=1).long()
        pe = self.syb_positional_encoding(pos_ids)
        if self.pe_dropout is not None:
            pe = self.pe_dropout(pe, generator)
        fea = self.fea_dropout(fea + pe, generator)

        graph_diag, graph_cross, graph, dec_mask = build_stage_graphs(
            modality_mask, q_mask, q_graph, modality_graph,
            use_dec_mask=cfg.use_dec_mask, distinct_cross_stage=cfg.distinct_cross_stage,
            mod_seg=mod_seg, q_seg=q_seg, n_pack=n_pack,
        )
        for i in range(cfg.num_blocks):
            g = (graph_diag if i < cfg.stage1_blocks
                 else graph_cross if i < cfg.stage2_blocks else graph)
            if cfg.remat_blocks and torch.is_grad_enabled():
                # keep only the block's input; its activations are computed
                # again in the backward (the TPU package's nn.remat)
                fea = checkpoint(self._enc_block, i, fea, g, use_reentrant=False)
            else:
                fea = self._enc_block(i, fea, g)

        # one decoder token per pack slot, each behaving as the reference's
        # single token: self-attention runs at (B*K, 1, C), the exact 1-token
        # path; cross-attention at (B, K, L) with the per-slot dec_mask
        dec_ids = torch.full((b, n_pack), BOS_ID, dtype=torch.long, device=fea.device)
        dec = self.dec_emb(dec_ids) + self.dec_positional_encoding(torch.zeros_like(dec_ids))
        dec = self.dec_dropout(dec, generator)
        for i in range(cfg.num_blocks):
            tok = dec.reshape(b * n_pack, 1, h)
            dec = getattr(self, f"dec_self_attention_{i}")(tok, tok, tok).reshape(b, n_pack, h)
            cross = getattr(self, f"dec_vanilla_attention_{i}")
            if self.dec_cross == "vanilla":
                if n_pack != 1:
                    raise ValueError("the vanilla decoder cross-attention has no pack mask")
                dec = cross(dec, fea, fea)
            else:
                dec = cross(dec, fea, fea, dec_mask)
            dec = getattr(self, f"dec_feed_forward_{i}")(dec)
        return dec  # (B, n_pack, hidden)


class VisualEncoder(_Branch):
    """Visual branch: region features ++ question nodes."""

    def __init__(self, cfg: ModelConfig, glove: Optional[GloVeEmbed] = None, device=None):
        super().__init__(cfg, cfg.maxlen, pe_dropout=True, glove=glove, device=device)

    def forward(self, vis_fea, vis_mask, q_ids, q_graph, q_mask,
                generator: Optional[torch.Generator] = None, **packing):
        return super().forward(vis_fea, vis_mask, None, q_ids, q_graph, q_mask, generator,
                               **packing)


class SymbolicEncoder(_Branch):
    """Symbolic branch: MIL-rewritten macro nodes ++ question."""

    def __init__(self, cfg: ModelConfig, glove: Optional[GloVeEmbed] = None, device=None):
        super().__init__(cfg, cfg.maxlen + cfg.maxlen_q, pe_dropout=False, glove=glove,
                         device=device)


class MILNCEModule(nn.Module):
    """Structured alignment: MIL-NCE grounding + super-node rewrite, object
    branch and, unless ``cfg.only_obj``, relation branch. ``ipt_out_local``:
    on the model axis, ``ipt_mlp``'s columns stay this rank's for the
    symbolic branch's row-split ``syb_mlp2`` (:func:`link_model_splits`)."""

    ipt_out_local = False

    def __init__(self, cfg: ModelConfig, glove: Optional[GloVeEmbed] = None, device=None):
        super().__init__()
        dt = cfg.compute_dtype
        h = cfg.hidden_size_mil
        self.syb_emb = (glove if glove is not None
                        else GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, device,
                                        cfg.int8_serving))
        self.marco_mlp = linear_relu(cfg.glove_dim, h, dt, device)
        self.syb_mlp = linear_relu(cfg.glove_dim, h, dt, device)
        self.vis_mlp = linear_relu(cfg.vis_fea_dim, h, dt, device)
        self.ipt_mlp = linear_relu(h, cfg.vis_fea_dim, dt, device)
        self.compute_dtype = dt
        self.only_obj = cfg.only_obj
        if not cfg.only_obj:
            # one bilinear form per relation category, kept and used in float32
            self.R = nn.Parameter(torch.empty(cfg.num_relations, h, h, device=device))
            nn.init.xavier_normal_(self.R)

    def forward(self, vis_fea, macro_ipt, macro_obj_loc, micro_pos_obj, micro_neg_obj,
                micro_obj_mask, micro_pos_rel=None, micro_pos_rel_loc=None,
                micro_neg_rel_loc=None):
        """Returns ``(new_macro (B, Ls, vis_fea_dim), mil_obj, mil_rel)``;
        ``mil_rel`` is 0 on the obj-only path, which ignores the relation
        arguments."""
        b, ls = macro_ipt.shape
        glove = self.syb_emb

        new_macro = self.marco_mlp(glove(macro_ipt)).detach()
        pos_fea = self.syb_mlp(glove(micro_pos_obj))              # (B, O, topN, h)
        neg_fea = self.syb_mlp(glove(micro_neg_obj))
        vis_emb = self.vis_mlp(vis_fea.to(self.compute_dtype))    # (B, O, h)

        pos_scores = torch.einsum("both,boh->bot", pos_fea.float(), vis_emb.float())
        neg_scores = torch.einsum("both,boh->bot", neg_fea.float(), vis_emb.float())
        obj_mask = micro_obj_mask.float()
        mil_obj = mil_nce_obj_objective(pos_scores * obj_mask, neg_scores * obj_mask)

        # super-node rewrite: softmax over the *unmasked* scores
        w = torch.softmax(pos_scores, dim=2).to(pos_fea.dtype)
        new_obj_fea = (w[..., None] * pos_fea).sum(dim=2)        # (B, O, h)

        # scatter into the macro rows; -1 locations go to a spare row that is dropped
        safe_loc = torch.where(macro_obj_loc >= 0, macro_obj_loc,
                               torch.full_like(macro_obj_loc, ls))
        rows = torch.arange(b, device=macro_ipt.device)[:, None].expand_as(safe_loc)
        padded = torch.cat([new_macro, new_macro.new_zeros(b, 1, new_macro.shape[2])], dim=1)
        padded = padded.index_put((rows, safe_loc), new_obj_fea.to(padded.dtype))
        new_macro = padded[:, :ls]
        if self.only_obj:
            mil_rel = torch.zeros((), dtype=torch.float32, device=mil_obj.device)
        else:
            new_macro, mil_rel = self._relation_branch(
                new_macro, new_obj_fea, micro_pos_rel, micro_pos_rel_loc, micro_neg_rel_loc)
        return dense_relu(self.ipt_mlp, new_macro, local_out=self.ipt_out_local), mil_obj, mil_rel

    def _relation_branch(self, new_macro, new_obj_fea, micro_pos_rel, micro_pos_rel_loc,
                         micro_neg_rel_loc):
        """Relation MIL-NCE + super-node relation rewrite (reference
        ``AttModel_x3.py:382-439``).

        The reference computes the full (B, num_relations, O, O) bilinear
        tensor x_i^T R_r x_j and gathers a few entries; as in the TPU
        package the entries are gathered first and contracted one by one.
        Loc records are [obj_i, obj_j, rel_cat, macro_loc, micro_loc], -1 in
        padding rows.
        """
        b, k = micro_pos_rel.shape
        ls = new_macro.shape[1]
        n_obj = new_obj_fea.shape[1]
        n_rel = self.R.shape[0]
        bi = torch.arange(b, device=new_macro.device)[:, None]

        rel_fea = self.syb_mlp(self.syb_emb(micro_pos_rel))       # (B, K, h)

        def gathered_bilinear(loc):
            xi = new_obj_fea[bi, loc[..., 0].clamp(0, n_obj - 1)].float()   # (B, K, h)
            xj = new_obj_fea[bi, loc[..., 1].clamp(0, n_obj - 1)].float()
            r_k = self.R[loc[..., 2].clamp(0, n_rel - 1)]                   # (B, K, h, h)
            return torch.einsum("bkh,bkhg,bkg->bk", xi, r_k, xj)

        pos_valid = micro_pos_rel_loc[..., 3] >= 0
        neg_valid = micro_neg_rel_loc[..., 3] >= 0
        pos_scores = gathered_bilinear(micro_pos_rel_loc).reshape(-1)
        neg_scores = gathered_bilinear(micro_neg_rel_loc).reshape(-1)
        all_pos, all_pos_valid = pos_scores, pos_valid.reshape(-1)
        all_neg, all_neg_valid = neg_scores, neg_valid.reshape(-1)
        mesh = distributed_mesh()
        if mesh is not None:
            # the global batch's records in rank order, as the TPU package's
            # global-batch step flattens them: the objective and the joint
            # softmax below run over every rank's positives
            all_pos, all_neg = gather_scores([pos_scores, neg_scores], mesh)
            valids, _ = gather_rows([all_pos_valid, all_neg_valid], mesh)
            all_pos_valid, all_neg_valid = (v.bool() for v in valids)
        mil_rel = mil_nce_rel_objective(all_pos, all_pos_valid, all_neg, all_neg_valid)
        if mesh is not None:
            mil_rel = mil_rel / mesh.world   # every rank's share: see gather_scores

        # zero every positive-relation macro row, then add the softmax-weighted
        # relation embeddings; invalid records go to a spare row that is dropped
        macro_loc = micro_pos_rel_loc[..., 3]
        micro_loc = micro_pos_rel_loc[..., 4]
        safe_loc = torch.where(pos_valid, macro_loc, torch.full_like(macro_loc, ls))
        rows = bi.expand_as(safe_loc)
        row_zero = new_macro.new_zeros(b, ls + 1).index_put(
            (rows, safe_loc), new_macro.new_ones(()))[:, :ls]
        new_macro = new_macro * (1.0 - row_zero[..., None])

        # each sample reads entry micro_loc of the compacted positives of the
        # whole (global) batch, the reference's quirk: under a mesh, entries
        # other ranks' samples wrote
        weights = compact_softmax_gather(
            all_pos, all_pos_valid,
            torch.where(pos_valid, micro_loc, torch.full_like(micro_loc, -1)).reshape(-1),
        ).reshape(b, k)
        contrib = weights[..., None].to(new_macro.dtype) * rel_fea[bi, micro_loc.clamp(0, k - 1)]
        contrib = torch.where(pos_valid[..., None], contrib, torch.zeros_like(contrib))
        # several records may name one macro row. Their contributions are
        # summed in float32 (index_put with accumulate sorts the indices on
        # the card, so the order and the bits are the same on every run) and
        # rounded once; the rows they land on were zeroed just above.
        added = torch.zeros(b, ls + 1, new_macro.shape[2], dtype=torch.float32,
                            device=new_macro.device).index_put(
            (rows, safe_loc), contrib.float(), accumulate=True)[:, :ls]
        return new_macro + added.to(new_macro.dtype), mil_rel


class _Head(nn.Sequential):
    """Linear -> ReLU -> Dropout -> Linear classifier (``cls.0`` / ``cls.3``);
    int8 ``QDense`` layers under ``int8_serving``."""

    def __init__(self, cfg: ModelConfig, fin: int, device=None):
        dt = cfg.compute_dtype
        dense = QDense if cfg.int8_serving else Linear
        super().__init__(
            dense(fin, cfg.hidden_size, dt, device), nn.ReLU(), Dropout(cfg.dropout_rate),
            dense(cfg.hidden_size, cfg.num_classes, dt, device),
        )

    def forward(self, x, generator: Optional[torch.Generator] = None):
        hidden, relu, drop, out = self
        return out(drop(relu(hidden(x)), generator))


class MCB(nn.Module):
    """The MCB fusion's two frozen count sketches (buffers ``sketch1`` and
    ``sketch2``, the reference's ``mcb.sketch1``/``mcb.sketch2``): saved in
    the state_dict, never trained. Drawn from
    ``np.random.default_rng(MCB_SKETCH_SEED)``, sketch1 first, as the TPU
    package draws them."""

    def __init__(self, input_dim: int, output_dim: int, device=None):
        super().__init__()
        rng = np.random.default_rng(MCB_SKETCH_SEED)
        for name in ("sketch1", "sketch2"):
            self.register_buffer(name, torch.from_numpy(
                count_sketch_matrix(rng, input_dim, output_dim)).to(device))
        self.output_dim = output_dim

    def forward(self, x_syb: torch.Tensor, x_vis: torch.Tensor) -> torch.Tensor:
        return compact_bilinear_pooling(x_syb, x_vis, self.sketch1, self.sketch2,
                                        self.output_dim)


_PACKING_FIELDS = ("vis_seg", "macro_seg", "q_seg", "vis_pos", "macro_pos", "q_pos")


class AttModelX3(nn.Module):
    """Top-level SA-VQA model. Returns
    ``(logits_concat, logits_vis, logits_syb, mil_nce_obj, mil_nce_rel)``;
    the logits are (B, C), or (B, n_pack, C) on a packed batch.

    ``device=None`` puts the model on the CUDA card and raises if there is
    none; pass ``device="cpu"`` to build it on the CPU. With ``use_mcb`` the
    concat head ``cls`` gives way to ``cls_mcb`` over the MCB fusion of the
    two branches (``mcb_out`` wide).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        cfg.check_supported()
        dev = resolve_device(device)
        self.cfg = cfg
        shared = (GloVeEmbed(cfg.vocab_size, cfg.glove_dim, cfg.compute_dtype, dev,
                             cfg.int8_serving)
                  if cfg.share_glove else None)
        self.MIL_NCE = MILNCEModule(cfg, glove=shared, device=dev)
        self.att_vis_grid = VisualEncoder(cfg, glove=shared, device=dev)
        self.att_syb = SymbolicEncoder(cfg, glove=shared, device=dev)
        if cfg.use_mcb:
            self.mcb = MCB(cfg.hidden_size, cfg.mcb_out, dev)
            self.mcb_dropout = Dropout(cfg.dropout_rate_mcb)
            self.cls_mcb = _Head(cfg, cfg.mcb_out, dev)
        else:
            self.cls = _Head(cfg, 2 * cfg.hidden_size, dev)
        self.cls_vis = _Head(cfg, cfg.hidden_size, dev)
        self.cls_syb = _Head(cfg, cfg.hidden_size, dev)

    def forward(self, batch: VQABatch, generator: Optional[torch.Generator] = None):
        """In train mode every dropout mask is drawn from ``generator`` (on
        the batch's device; ``None`` means torch's default generator). In
        eval mode, or at dropout rate 0, no mask is drawn."""
        packed = batch.vis_seg is not None
        if packed != (batch.answer.ndim == 2) or any(
                (getattr(batch, f) is None) == packed for f in _PACKING_FIELDS):
            raise ValueError("a packed batch carries all six segment and position fields "
                             "and (B, n_pack) answers; an unpacked one none of them and "
                             "(B,) answers")
        n_pack = batch.n_pack
        new_macro, mil_obj, mil_rel = self.MIL_NCE(
            batch.vis_fea, batch.macro_ipt, batch.macro_obj_loc,
            batch.micro_pos_obj, batch.micro_neg_obj, batch.micro_obj_mask,
            batch.micro_pos_rel, batch.micro_pos_rel_loc, batch.micro_neg_rel_loc,
        )
        fea_vis = self.att_vis_grid(
            batch.vis_fea, batch.vis_mask, batch.q_ipt, batch.q_graph, batch.q_mask, generator,
            mod_seg=batch.vis_seg, q_seg=batch.q_seg, mod_pos=batch.vis_pos,
            q_pos=batch.q_pos, n_pack=n_pack)
        fea_syb = self.att_syb(
            new_macro, batch.macro_mask, batch.macro_graph, batch.q_ipt, batch.q_graph,
            batch.q_mask, generator, mod_seg=batch.macro_seg, q_seg=batch.q_seg,
            mod_pos=batch.macro_pos, q_pos=batch.q_pos, n_pack=n_pack)
        if not packed:   # one decoder token: (B, 1, hidden) -> (B, hidden)
            fea_vis, fea_syb = fea_vis[:, 0], fea_syb[:, 0]
        logits_vis = self.cls_vis(fea_vis, generator)
        logits_syb = self.cls_syb(fea_syb, generator)
        if self.cfg.use_mcb:
            # float32 (B[, K], mcb_out), normalized over the batch axis
            fused = self.mcb_dropout(self.mcb(fea_syb, fea_vis), generator)
            logits_concat = self.cls_mcb(fused, generator)
        else:
            logits_concat = self.cls(torch.cat([fea_syb, fea_vis], dim=-1), generator)
        return logits_concat, logits_vis, logits_syb, mil_obj, mil_rel


def link_model_splits(model: nn.Module) -> None:
    """Pair ``MIL_NCE.ipt_mlp`` with ``att_syb.syb_mlp2`` when the model
    axis splits the first by columns and the second by rows: the symbolic
    branch then takes ipt_mlp's columns as they are
    (``parallel/sharding.py:shard_model`` calls this)."""
    mil, syb = getattr(model, "MIL_NCE", None), getattr(model, "att_syb", None)
    if not isinstance(mil, MILNCEModule) or not isinstance(syb, _Branch):
        return
    ipt, mlp2 = mil.ipt_mlp[0].model_split, syb.syb_mlp2.model_split
    paired = ipt is not None and ipt.dim == 0 and mlp2 is not None and mlp2.dim == 1
    mil.ipt_out_local = syb.modality_local = paired


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator, noise: float = 0.05) -> None:
    """Random weights from ``generator``, off the LayerNorm knife edge.

    Tables, matrices and the relation tensor get a normal draw at xavier
    scale (std sqrt(2 / (fan_in + fan_out))). Vectors get ``noise`` times a
    standard normal on top of their init: LayerNorm gamma 1 + noise*N, beta
    and biases noise*N, so no post-LN row sums to exactly 0.
    ``generator`` must live on the parameters' device.
    """
    for name, p in model.named_parameters():
        draw = torch.randn(p.shape, generator=generator, device=p.device)
        if p.dim() >= 2:
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(p)
            p.copy_(draw * (2.0 / (fan_in + fan_out)) ** 0.5)
        else:
            p.copy_((1.0 if name.endswith("gamma") else 0.0) + noise * draw)
