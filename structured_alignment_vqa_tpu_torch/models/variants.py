"""The ablation-model matrix (counterpart of the TPU package's
``models/variants.py``): the reference's 17 ``transformers/`` file forks
over 11 model classes.

Family map (reference name -> class here):

* ``x``, ``x2``, ``x2_pre``, ``x2_distill`` -> :class:`MaxPoolDualEncoder`
* ``x2_dec``, ``x2_mlp_dec``, ``x2_syb_dec``, ``x2_fusion_dec`` -> :class:`X2DecModel`
* ``x2_dec_ori`` -> :class:`X2DecOriModel`; ``x4_dec`` -> :class:`X4DecModel`
* ``x5_dec_mil``, ``x6_dec_mil``, ``x7_dec_mil`` -> :class:`X5DecMil`,
  :class:`X6DecMil`, :class:`X7DecMil`
* ``x2_fusion_dec_mil``, ``x2_fusion_dec_mil2`` -> :class:`X2FusionDecMil`,
  :class:`X2FusionDecMil2`
* ``x2_fusion_dec_relatt`` -> :class:`X2FusionDecRelatt`
* ``x3_ori`` -> :class:`X3OriModel`

Class and helper names are the TPU package's, so each has its counterpart
there. Parameters carry the reference forks' torch state-dict names (as
``models/att_model_x3.py`` does), so a module of the TPU package that is
one flax scope may be two torch modules here or the other way round;
``models/convert_variants.py`` maps one onto the other. Parameters the
reference constructs but never calls (the symbolic blocks 4 and 5 of the
max-pool family, fusion_dec_mil's ``att_syb_dec``, mil2's ``syb_mlp1``) are
not built, so a converted state dict loads with ``strict=True``.

Every model runs its attention through ``ops/attention.py``, so graph
attention with a renorm takes K1 (K4 above 512 keys) and every FFN K3 on
the card, as in AttModelX3; a call that returns attention weights or draws
attention dropout runs the plain ``attention_core`` there too, as in the
TPU package. ``GraphMaskAttention`` with no graph is mask-only attention
(softmax, then the sum + 1e-7 renorm). The models return raw logits, plus
attention weights for the MIL line (fed to ``train/att_mil_loss.py``) and
``x3_ori``'s two MIL-NCE terms. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from structured_alignment_vqa_tpu_torch.device import resolve_device
from structured_alignment_vqa_tpu_torch.models.att_model_x3 import (
    BOS_ID,
    GloVeEmbed,
    _Branch,
    _Head,
    build_stage_graphs,
)
from structured_alignment_vqa_tpu_torch.models.config import ModelConfig
from structured_alignment_vqa_tpu_torch.ops.attention import (
    GraphGuidedAttention,
    GraphMaskAttention,
    MultiHeadAttention,
)
from structured_alignment_vqa_tpu_torch.ops.layers import (
    Dropout,
    Embedding,
    FeedForward,
    Linear,
    linear_relu,
)


def _positions(b: int, length: int, device) -> torch.Tensor:
    return torch.arange(length, device=device).expand(b, length)


def _pe_table(size: int, cfg: ModelConfig, device, width: Optional[int] = None) -> Embedding:
    """A learned positional table (no zero row, no scale)."""
    return Embedding(size, width or cfg.hidden_size, zeros_pad=False, scale=False,
                     dtype=cfg.compute_dtype, device=device)


def _seq_pe(size: int, cfg: ModelConfig, device, dropout: bool = True) -> nn.Sequential:
    """A positional table in a Sequential (the reference's names
    ``.0.lookup_table``), followed by its dropout unless ``dropout=False``."""
    table = _pe_table(size, cfg, device)
    return nn.Sequential(table, Dropout(cfg.dropout_rate)) if dropout else nn.Sequential(table)


def _seq_pe_rows(seq: nn.Sequential, ids: torch.Tensor, generator) -> torch.Tensor:
    """The rows of a :func:`_seq_pe` table, dropped out where it has a dropout."""
    out = seq[0](ids)
    return seq[1](out, generator) if len(seq) > 1 else out


def _attention_ffn_blocks(mod: nn.Module, attn_cls, cfg: ModelConfig, names, device,
                          width: Optional[int] = None, **attn_kw) -> None:
    """Register one (attention, FFN) pair per ``(attention name, FFN name)``."""
    h = width or cfg.hidden_size
    for att_name, ffn_name in names:
        mod.add_module(att_name, attn_cls(h, cfg.num_heads, dtype=cfg.compute_dtype,
                                          device=device, **attn_kw))
        mod.add_module(ffn_name, FeedForward(h, (4 * h, h), cfg.compute_dtype, device))


def _enc_names(n: int, prefix: str = "enc"):
    return [(f"{prefix}_self_attention_{i}", f"{prefix}_feed_forward_{i}") for i in range(n)]


def _max_pool_rows(x: torch.Tensor) -> torch.Tensor:
    return x.max(dim=1).values


def _last_writer_put(dest: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
                     ) -> torch.Tensor:
    """``dest[b, rows[b, k]] = values[b, k]`` for k in order, later writes
    overwriting earlier ones; rows outside ``[0, L)`` write nothing.

    The last writer of each (sample, row) is found first and every row is
    written once: one ``index_put`` with duplicate indices leaves the winner
    undefined on the card. dest (B, L, D), rows (B, K), values (B, K, D).
    """
    b, length = dest.shape[:2]
    k = rows.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=rows.device).triu(1)
    overwritten = ((rows[:, :, None] == rows[:, None, :]) & later).any(dim=-1)
    keep = (rows >= 0) & (rows < length) & ~overwritten
    target = torch.where(keep, rows, torch.full_like(rows, length))
    padded = torch.cat([dest, dest.new_zeros(b, 1, *dest.shape[2:])], dim=1)
    bi = torch.arange(b, device=rows.device)[:, None].expand_as(target)
    return padded.index_put((bi, target), values.to(dest.dtype))[:, :length]


class _TwoLayerMLP(nn.Sequential):
    """Linear -> ReLU -> Linear (``.0``/``.2``), or with ``relu=False`` two
    bare Linears (``.0``/``.1``; the x2_dec line comments its ReLU out)."""

    def __init__(self, fin: int, hidden: int, out: int, dtype, device, relu: bool = True):
        layers = [Linear(fin, hidden, dtype, device)]
        if relu:
            layers.append(nn.ReLU())
        layers.append(Linear(hidden, out, dtype, device))
        super().__init__(*layers)


def _stage_graphs_1d(mod_mask, q_mask, q_graph, mod_graph, style: str, visual: bool = True):
    """Stage graphs from 1-D masks, the x / x2 / x2_distill constructions
    (the TPU package's ``_stage_graphs_1d``): x gives ``[None, final]``,
    x2 and x2_distill ``[graph_diag, graph_cross, graph_full]``, float32."""
    b, lm = mod_mask.shape
    lq = q_mask.shape[1]
    size = lm + lq
    f32 = torch.float32
    dev = mod_mask.device
    qm, mm = q_mask.to(f32), mod_mask.to(f32)

    if style == "x":
        final = torch.zeros(b, size, size, dtype=f32, device=dev)
        if mod_graph is not None:
            final[:, :lm, :lm] = mod_graph.to(f32)
        final[:, lm:, lm:] = q_graph.to(f32)
        return [None, final]

    ones = torch.ones((), dtype=f32, device=dev)
    if style == "x2":   # key validity: block[:, i, j] = mask[j]
        q_blk = qm[:, None, :].expand(b, lq, lq)
        m_blk = ones.expand(b, lm, lm) if visual else mm[:, None, :].expand(b, lm, lm)
        cross_mq = qm[:, None, :].expand(b, lm, lq)
        cross_qm = ones.expand(b, lq, lm) if visual else mm[:, None, :].expand(b, lq, lm)
    else:               # x2_distill: query-validity diagonal, constant-1 cross
        q_blk = qm[:, :, None].expand(b, lq, lq)
        m_blk = ones.expand(b, lm, lm) if visual else mm[:, :, None].expand(b, lm, lm)
        cross_mq = ones.expand(b, lm, lq)
        cross_qm = ones.expand(b, lq, lm)

    graph_diag = torch.zeros(b, size, size, dtype=f32, device=dev)
    graph_diag[:, :lm, :lm] = m_blk
    graph_diag[:, lm:, lm:] = q_blk
    graph_cross = torch.zeros(b, size, size, dtype=f32, device=dev)
    graph_cross[:, :lm, lm:] = cross_mq
    graph_cross[:, lm:, :lm] = cross_qm
    graph_full = torch.ones(b, size, size, dtype=f32, device=dev)
    if mod_graph is not None:
        graph_full[:, :lm, :lm] = mod_graph.to(f32)
    graph_full[:, lm:, lm:] = q_graph.to(f32)
    return [graph_diag, graph_cross, graph_full]


# ---------------------------------------------------------------- max-pool family


class _DualInput(nn.Module):
    """The input side shared by the max-pool and dec-ori branches: the
    modality projection (visual: ``v_mlp`` on the region features; symbolic:
    ``syb_emb`` then ``syb_mlp`` on the node ids), ``q_mlp`` on the
    question's GloVe rows, and one dropped-out positional table each
    (``q_positional_encoding`` and ``v_``/``syb_positional_encoding``)."""

    def __init__(self, cfg: ModelConfig, is_visual: bool, pe_size: int, device):
        super().__init__()
        dt = cfg.compute_dtype
        h = cfg.hidden_size
        self.cfg = cfg
        self.is_visual = is_visual
        if is_visual:
            self.v_mlp = _TwoLayerMLP(cfg.vis_fea_dim, h, h, dt, device)
            self.v_positional_encoding = _seq_pe(pe_size, cfg, device)
        else:
            self.syb_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, device)
            self.syb_mlp = _TwoLayerMLP(cfg.glove_dim, cfg.vis_fea_dim, h, dt, device)
            self.syb_positional_encoding = _seq_pe(pe_size, cfg, device)
        self.q_mlp = _TwoLayerMLP(cfg.glove_dim, h, h, dt, device)
        self.q_positional_encoding = _seq_pe(cfg.maxlen_q, cfg, device)

    def tokens(self, mod_input, q_fea, generator):
        """(B, Lm + Lq, h): the modality tokens, then the question's."""
        dt = self.cfg.compute_dtype
        if self.is_visual:
            m, pe = self.v_mlp(mod_input.to(dt)), self.v_positional_encoding
        else:
            m, pe = self.syb_mlp(self.syb_emb(mod_input)), self.syb_positional_encoding
        b, lm, lq = m.shape[0], m.shape[1], q_fea.shape[1]
        q = self.q_mlp(q_fea) + _seq_pe_rows(self.q_positional_encoding,
                                            _positions(b, lq, m.device), generator)
        m = m + _seq_pe_rows(pe, _positions(b, lm, m.device), generator)
        return torch.cat([m, q], dim=1)


class _MaxPoolBranch(_DualInput):
    """One encoder branch of the x / x2 / x2_distill family: modality ++
    question tokens, graph-staged GraphMask blocks, max-pool.

    Two reference quirks are kept: the symbolic branch's final stage re-runs
    blocks ``0 .. num_blocks // 2`` (the same modules) instead of advancing,
    so its blocks past ``stage2_blocks`` are never called and not built; and
    x2's symbolic branch pools the *unmasked* features. The x fork names its
    second-stage blocks ``enc_self_attention_graph_j`` (the TPU package's
    block ``num_blocks // 2 + j``).
    """

    def __init__(self, cfg: ModelConfig, stage_style: str, is_visual: bool, pe_size: int,
                 device):
        super().__init__(cfg, is_visual, pe_size, device)
        self.stage_style = stage_style
        n = cfg.num_blocks
        half = n // 2
        if stage_style == "x":
            self.plan = ([(f"enc_self_attention_{i}", f"enc_feed_forward_{i}", 0)
                          for i in range(half)]
                         + [(f"enc_self_attention_graph_{j}", f"enc_feed_forward_graph_{j}", 1)
                            for j in range(n - half)])
        else:
            s1, s2 = cfg.stage1_blocks, cfg.stage2_blocks
            final = list(range(s2, n) if is_visual else range(half))
            stage = [0] * s1 + [1] * (s2 - s1) + [2] * len(final)
            self.plan = [(f"enc_self_attention_{i}", f"enc_feed_forward_{i}", st)
                         for i, st in zip(list(range(s2)) + final, stage)]
        built = dict.fromkeys((a, f) for a, f, _ in self.plan)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, list(built), device)

    def forward(self, mod_input, mod_mask, mod_graph, q_fea, q_graph, q_mask, generator=None):
        fea = self.tokens(mod_input, q_fea, generator)
        mask_1d = torch.cat([mod_mask.float(), q_mask.float()], dim=1)
        stages = _stage_graphs_1d(mod_mask, q_mask, q_graph, mod_graph, self.stage_style,
                                  visual=self.is_visual)
        for att, ffn, stage in self.plan:
            fea = getattr(self, att)(fea, fea, fea, stages[stage])
            fea = getattr(self, ffn)(fea)
        masked = fea * mask_1d[..., None].to(fea.dtype)
        unmasked = self.stage_style == "x2" and not self.is_visual
        return _max_pool_rows(fea if unmasked else masked)


class MaxPoolDualEncoder(nn.Module):
    """x / x2 / x2_pre / x2_distill: two max-pooled branches, concat, one head.

    ``forward(vis_fea, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d,
    syb_graph, generator=None)`` -> logits (B, num_classes)."""

    def __init__(self, cfg: ModelConfig, stage_style: str = "x2", device=None):
        super().__init__()
        dev = resolve_device(device)
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.q_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, dev)
        self.att_vis_grid = _MaxPoolBranch(cfg, stage_style, True, cfg.maxlen_v, dev)
        self.att_syb = _MaxPoolBranch(cfg, stage_style, False, cfg.maxlen, dev)
        self.cls = _Head(cfg, 2 * cfg.hidden_size, dev)

    def forward(self, vis_fea, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d, syb_graph,
                generator: Optional[torch.Generator] = None):
        q_fea = self.q_emb(q_ipt)
        b, lv = vis_fea.shape[:2]
        vis_mask_1d = torch.ones(b, lv, device=vis_fea.device)   # grid features: all valid
        fea_vis = self.att_vis_grid(vis_fea, vis_mask_1d, None, q_fea, q_graph, q_mask_1d,
                                    generator)
        fea_syb = self.att_syb(syb_ipt, syb_mask_1d, syb_graph, q_fea, q_graph, q_mask_1d,
                               generator)
        return self.cls(torch.cat([fea_syb, fea_vis], dim=1), generator)


# ----------------------------------------------------------------- staged encoders


class _OneTokenDecoder(nn.Module):
    """1-token decoder stack: BOS embedding + positional row 0, then per
    block causal self-attention, graph-guided cross-attention into the
    encoded sequence under ``dec_mask`` (``dec_cross="vanilla"``:
    content-masked multi-head attention with no mask), FFN.

    :meth:`build` and :meth:`decode` also put the decoder on a module that
    holds an encoder beside it, where the reference has the two in one
    torch module (its names ``dec_emb``, ``dec_self_attention_i``, ...).
    """

    def __init__(self, cfg: ModelConfig, pe_table_size: int, device=None):
        super().__init__()
        _OneTokenDecoder.build(self, cfg, pe_table_size, device)

    @staticmethod
    def build(mod: nn.Module, cfg: ModelConfig, pe_table_size: int, device,
              dec_cross: str = "graph") -> None:
        dt, h = cfg.compute_dtype, cfg.hidden_size
        mod.dec_emb = Embedding(cfg.num_classes, h, zeros_pad=True, scale=True, dtype=dt,
                                device=device)
        mod.dec_positional_encoding = _pe_table(pe_table_size, cfg, device)
        mod.dec_dropout = Dropout(cfg.dropout_rate)
        mod.dec_cross = dec_cross
        mod.dec_blocks = cfg.num_blocks
        cross = GraphGuidedAttention if dec_cross == "graph" else MultiHeadAttention
        for i in range(cfg.num_blocks):
            mod.add_module(f"dec_self_attention_{i}", MultiHeadAttention(
                h, cfg.num_heads, causality=True, dtype=dt, device=device))
            mod.add_module(f"dec_vanilla_attention_{i}", cross(
                h, cfg.num_heads, dtype=dt, device=device))
            mod.add_module(f"dec_feed_forward_{i}", FeedForward(h, (4 * h, h), dt, device))

    @staticmethod
    def decode(mod: nn.Module, fea, dec_mask, generator=None) -> torch.Tensor:
        """(B, 1, h)."""
        b = fea.shape[0]
        ids = torch.full((b, 1), BOS_ID, dtype=torch.long, device=fea.device)
        dec = mod.dec_emb(ids) + mod.dec_positional_encoding(torch.zeros_like(ids))
        dec = mod.dec_dropout(dec, generator)
        for i in range(mod.dec_blocks):
            dec = getattr(mod, f"dec_self_attention_{i}")(dec, dec, dec)
            cross = getattr(mod, f"dec_vanilla_attention_{i}")
            dec = cross(dec, fea, fea) if mod.dec_cross == "vanilla" else cross(
                dec, fea, fea, dec_mask)
            dec = getattr(mod, f"dec_feed_forward_{i}")(dec)
        return dec

    def forward(self, fea, dec_mask, generator: Optional[torch.Generator] = None):
        return _OneTokenDecoder.decode(self, fea, dec_mask, generator)


class _StagedEncoderOnly(nn.Module):
    """The x2_dec / x3 staged encoder without its decoder: returns the
    encoded sequence and the decoder mask.

    ``ids_input`` (the symbolic side): the node ids and the question ids
    are embedded jointly through ``syb_mlp``, a two-layer MLP (two bare
    Linears in the fusion line; ``mlp_relu`` and ``mlp_name`` give x2_mlp_dec's
    ReLU'd ``syb_mlp_sequence``). Otherwise (the visual side): the question's
    rows go through ``syb_mlp``, a bare Linear, and the concatenation
    through ``syb_mlp2``. ``pe_sequential`` puts the positional table in a
    Sequential (the reference's name ``syb_positional_encoding.0``); the
    sum of features and positions is dropped out once either way, as in the
    TPU package.
    """

    def __init__(self, cfg: ModelConfig, pe_table_size: int, ids_input: bool,
                 glove: Optional[GloVeEmbed] = None, device=None, mlp_relu: bool = False,
                 mlp_name: str = "syb_mlp", pe_sequential: bool = False):
        super().__init__()
        dt, h = cfg.compute_dtype, cfg.hidden_size
        self.cfg = cfg
        self.ids_input = ids_input
        self.syb_emb = glove if glove is not None else GloVeEmbed(
            cfg.vocab_size, cfg.glove_dim, dt, device)
        self.mlp_name = mlp_name
        if ids_input:
            self.add_module(mlp_name, _TwoLayerMLP(cfg.glove_dim, cfg.vis_fea_dim, h, dt,
                                                   device, relu=mlp_relu))
        else:
            self.add_module(mlp_name, Linear(cfg.glove_dim, cfg.vis_fea_dim, dt, device))
            self.syb_mlp2 = Linear(cfg.vis_fea_dim, h, dt, device)
        pe = _pe_table(pe_table_size, cfg, device)
        self.syb_positional_encoding = nn.Sequential(pe) if pe_sequential else pe
        self.fea_dropout = Dropout(cfg.dropout_rate)
        _attention_ffn_blocks(self, GraphGuidedAttention, cfg, _enc_names(cfg.num_blocks),
                              device)

    def features(self, modality, q_ipt) -> torch.Tensor:
        """(B, Lm + Lq, h) before the positions."""
        mlp = getattr(self, self.mlp_name)
        if self.ids_input:
            return mlp(self.syb_emb(torch.cat([modality, q_ipt], dim=1)))
        fea = torch.cat([modality.to(self.cfg.compute_dtype), mlp(self.syb_emb(q_ipt))], dim=1)
        return self.syb_mlp2(fea)

    def encode(self, fea, modality_mask, modality_graph, q_graph, q_mask, generator=None):
        """Positions, dropout and the staged blocks: ``(fea, dec_mask)``."""
        cfg = self.cfg
        b, size = fea.shape[:2]
        fea = self.fea_dropout(fea + self.syb_positional_encoding(
            _positions(b, size, fea.device)), generator)
        graph_diag, graph_cross, graph, dec_mask = build_stage_graphs(
            modality_mask, q_mask, q_graph, modality_graph, use_dec_mask=cfg.use_dec_mask,
            distinct_cross_stage=cfg.distinct_cross_stage)
        for i in range(cfg.num_blocks):
            g = (graph_diag if i < cfg.stage1_blocks
                 else graph_cross if i < cfg.stage2_blocks else graph)
            fea = getattr(self, f"enc_self_attention_{i}")(fea, fea, fea, g)
            fea = getattr(self, f"enc_feed_forward_{i}")(fea)
        return fea, dec_mask

    def forward(self, modality, modality_mask, modality_graph, q_ipt, q_graph, q_mask,
                generator: Optional[torch.Generator] = None):
        return self.encode(self.features(modality, q_ipt), modality_mask, modality_graph,
                           q_graph, q_mask, generator)


class _StagedEncoderDecoder(_StagedEncoderOnly):
    """A :class:`_StagedEncoderOnly` with its :class:`_OneTokenDecoder` in the
    same module (the reference's ``att_syb`` of the x2_dec line and of
    relatt); ``forward`` returns the decoder's (B, 1, h)."""

    def __init__(self, cfg: ModelConfig, pe_table_size: int, ids_input: bool,
                 glove: Optional[GloVeEmbed] = None, device=None, dec_cross: str = "graph",
                 **kw):
        super().__init__(cfg, pe_table_size, ids_input, glove, device, **kw)
        _OneTokenDecoder.build(self, cfg, pe_table_size, device, dec_cross)

    def forward(self, modality, modality_mask, modality_graph, q_ipt, q_graph, q_mask,
                generator: Optional[torch.Generator] = None):
        fea, dec_mask = super().forward(modality, modality_mask, modality_graph, q_ipt,
                                        q_graph, q_mask, generator)
        return _OneTokenDecoder.decode(self, fea, dec_mask, generator)


# ------------------------------------------------------------------- x2_dec line


class X2DecModel(nn.Module):
    """x2_dec line: AttModelX3's dual encoder/decoder body without MIL-NCE
    (the symbolic branch embeds [node ids ++ question ids] directly), plus
    the ``vis_graph`` option (the visual block's adjacency from the input).

    ``heads`` 'single' (x2_dec, x2_mlp_dec) or 'triple' (x2_syb_dec,
    x2_fusion_dec); ``mlp_relu=False`` makes both question projections
    bare Linears (the x2_dec line); x2_mlp_dec has ``vis_v_mlp`` (a live
    Linear + ReLU on the region features, ``att_vis_grid.v_mlp``), ReLU'd
    ``syb_mlp_sequence`` projections and ``dec_cross="vanilla"``.
    ``vis_pe_sequential=False`` names the visual positional table bare, as
    X2FusionDecMil2's body does. ``forward(vis_fea, vis_mask, q_ipt, q_mask,
    q_graph, syb_ipt, syb_mask, syb_graph, vis_graph=None, generator=None)``
    with square (B, L, L) masks -> logits, or the tuple (concat, vis, syb).
    """

    def __init__(self, cfg: ModelConfig, heads: str = "single", mlp_relu: bool = True,
                 vis_v_mlp: bool = False, dec_cross: str = "graph", device=None,
                 vis_pe_sequential: bool = True):
        super().__init__()
        if heads not in ("single", "triple"):
            raise ValueError(f"unknown heads {heads!r}")
        dev = resolve_device(device)
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.heads = heads
        self.vis_v_mlp = vis_v_mlp
        shared = (GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, dev)
                  if cfg.share_glove else None)
        # the one fork of this class with ReLU'd projections (x2_mlp_dec)
        # names them syb_mlp_sequence
        mlp_name = "syb_mlp_sequence" if mlp_relu else "syb_mlp"
        self.att_vis_grid = _Branch(cfg, cfg.maxlen, pe_dropout=True, glove=shared, device=dev,
                                    mlp_relu=mlp_relu, dec_cross=dec_cross, mlp_name=mlp_name,
                                    pe_sequential=vis_pe_sequential)
        if vis_v_mlp:
            self.att_vis_grid.v_mlp = linear_relu(cfg.vis_fea_dim, cfg.vis_fea_dim, dt, dev)
        self.att_syb = _StagedEncoderDecoder(
            cfg, cfg.maxlen + cfg.maxlen_q, ids_input=True, glove=shared, device=dev,
            dec_cross=dec_cross, mlp_relu=mlp_relu, mlp_name=mlp_name)
        self.cls = _Head(cfg, 2 * cfg.hidden_size, dev)
        if heads == "triple":
            self.cls_vis = _Head(cfg, cfg.hidden_size, dev)
            self.cls_syb = _Head(cfg, cfg.hidden_size, dev)

    def forward(self, vis_fea, vis_mask, q_ipt, q_mask, q_graph, syb_ipt, syb_mask, syb_graph,
                vis_graph=None, generator: Optional[torch.Generator] = None):
        if self.vis_v_mlp:
            vis_fea = self.att_vis_grid.v_mlp(vis_fea)
        fea_vis = self.att_vis_grid(vis_fea, vis_mask, vis_graph, q_ipt, q_graph, q_mask,
                                    generator)
        fea_syb = self.att_syb(syb_ipt, syb_mask, syb_graph, q_ipt, q_graph, q_mask, generator)
        fused = torch.cat([fea_syb[:, 0], fea_vis[:, 0]], dim=1)
        if self.heads == "triple":
            return (self.cls(fused, generator), self.cls_vis(fea_vis, generator)[:, 0],
                    self.cls_syb(fea_syb, generator)[:, 0])
        return self.cls(fused, generator)


class _X2DecOriBranch(_DualInput):
    """One x2_dec_ori branch: an x2-style staged GraphMask encoder (no block
    reuse), then a PE-less 1-token decoder of GraphMask cross-attention
    blocks (no self-attention; BOS index 1 of a 2-row table).

    Quirks kept: the cross stage's question->modality block is constant 1
    in the visual branch and the modality key mask in the symbolic one; the
    visual decoder attends the masked encoder output, the symbolic one the
    unmasked. ``stage1_mask_only`` (x4_dec) runs the first stage with no
    graph and puts the key mask in the visual cross block too.
    """

    def __init__(self, cfg: ModelConfig, is_visual: bool, pe_size: int, device,
                 stage1_mask_only: bool = False):
        super().__init__(cfg, is_visual, pe_size, device)
        self.stage1_mask_only = stage1_mask_only
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, _enc_names(cfg.num_blocks), device)
        self.dec_emb = Embedding(2, cfg.hidden_size, zeros_pad=True, scale=True,
                                 dtype=cfg.compute_dtype, device=device)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, [
            (f"dec_vanilla_attention_{i}", f"dec_feed_forward_{i}")
            for i in range(cfg.num_blocks)], device)

    def forward(self, mod_input, mod_mask, mod_graph, q_fea, q_graph, q_mask, generator=None):
        cfg = self.cfg
        fea = self.tokens(mod_input, q_fea, generator)
        b = fea.shape[0]
        mask_1d = torch.cat([mod_mask.float(), q_mask.float()], dim=1)
        graphs = _stage_graphs_1d(mod_mask, q_mask, q_graph, mod_graph, "x2",
                                  visual=self.is_visual and not self.stage1_mask_only)
        graphs[0] = None if self.stage1_mask_only else self._diag(mod_mask, q_mask)
        s1, s2 = cfg.stage1_blocks, cfg.stage2_blocks
        for i in range(cfg.num_blocks):
            g = graphs[0] if i < s1 else graphs[1] if i < s2 else graphs[2]
            fea = getattr(self, f"enc_self_attention_{i}")(fea, fea, fea, g)
            fea = getattr(self, f"enc_feed_forward_{i}")(fea)
        if self.is_visual:
            fea = fea * mask_1d[..., None].to(fea.dtype)
        dec = self.dec_emb(torch.ones(b, 1, dtype=torch.long, device=fea.device))
        for i in range(cfg.num_blocks):
            dec = getattr(self, f"dec_vanilla_attention_{i}")(dec, fea, fea, None)
            dec = getattr(self, f"dec_feed_forward_{i}")(dec)
        return dec[:, 0]

    @staticmethod
    def _diag(mod_mask, q_mask):
        """x2_dec_ori's stage-1 graph: key-validity diagonal blocks in both
        branches (the visual one's modality block is its mask, not 1)."""
        b, lm = mod_mask.shape
        lq = q_mask.shape[1]
        g = torch.zeros(b, lm + lq, lm + lq, device=mod_mask.device)
        g[:, :lm, :lm] = mod_mask.float()[:, None, :]
        g[:, lm:, lm:] = q_mask.float()[:, None, :]
        return g


class X2DecOriModel(nn.Module):
    """x2_dec_ori: two :class:`_X2DecOriBranch` decoders, concat, one head.
    Takes 1-D masks (or the dec family's square ones, reduced by row sums).
    ``forward(vis_fea, vis_mask_1d, q_ipt, q_mask_1d, q_graph, syb_ipt,
    syb_mask_1d, syb_graph, generator=None)`` -> logits."""

    stage1_mask_only = False

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.q_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, cfg.compute_dtype, dev)
        self.att_vis_grid = _X2DecOriBranch(cfg, True, cfg.maxlen_v, dev, self.stage1_mask_only)
        self.att_syb = _X2DecOriBranch(cfg, False, cfg.maxlen, dev, self.stage1_mask_only)
        self.cls = _Head(cfg, 2 * cfg.hidden_size, dev)

    def forward(self, vis_fea, vis_mask_1d, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d,
                syb_graph, generator: Optional[torch.Generator] = None):
        def as_1d(mask):   # the dec family's square masks
            return (mask.sum(dim=2) > 0).float() if mask.dim() == 3 else mask

        vis_mask_1d, q_mask_1d, syb_mask_1d = map(as_1d, (vis_mask_1d, q_mask_1d, syb_mask_1d))
        q_fea = self.q_emb(q_ipt)
        fea_vis = self.att_vis_grid(vis_fea, vis_mask_1d, None, q_fea, q_graph, q_mask_1d,
                                    generator)
        fea_syb = self.att_syb(syb_ipt, syb_mask_1d, syb_graph, q_fea, q_graph, q_mask_1d,
                               generator)
        return self.cls(torch.cat([fea_syb, fea_vis], dim=1), generator)


class X4DecModel(X2DecOriModel):
    """x4_dec: "from v2_dec, just change the diag": x2_dec_ori with stage 1
    mask-only (no graph) and the modality key mask in both branches' cross
    blocks; the reference's parameter names are x2_dec_ori's."""

    stage1_mask_only = True


# --------------------------------------------------------------------- MIL line


class _SelfStack(nn.Module):
    """Per-modality mask-only GraphMask self-attention stack."""

    def __init__(self, cfg: ModelConfig, n_blocks: int, device):
        super().__init__()
        self.cfg = cfg
        self.n_blocks = n_blocks
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, _enc_names(n_blocks), device)

    def stack(self, fea, graph=None):
        for i in range(self.n_blocks):
            fea = getattr(self, f"enc_self_attention_{i}")(fea, fea, fea, graph)
            fea = getattr(self, f"enc_feed_forward_{i}")(fea)
        return fea


class _VisFeaPath(_SelfStack):
    """``att_vis``: v_mlp + dropped-out positions on the raw region features,
    then its mask-only self stack (the TPU package's ``att_vis`` and
    ``att_vis_stack``)."""

    def __init__(self, cfg: ModelConfig, n_blocks: int, device):
        super().__init__(cfg, n_blocks, device)
        h = cfg.hidden_size
        self.v_mlp = _TwoLayerMLP(cfg.vis_fea_dim, h, h, cfg.compute_dtype, device)
        self.v_positional_encoding = _seq_pe(cfg.maxlen_v, cfg, device)

    def forward(self, vis_fea, generator=None):
        b, lv = vis_fea.shape[:2]
        v = self.v_mlp(vis_fea.to(self.cfg.compute_dtype))
        v = v + _seq_pe_rows(self.v_positional_encoding, _positions(b, lv, v.device), generator)
        return self.stack(v, None)


class _SybFeaPath(_SelfStack):
    """``att_syb``: syb_emb + the 300 -> 2048 -> h MLP + dropped-out
    positions, then its self stack under the scene graph."""

    def __init__(self, cfg: ModelConfig, n_blocks: int, device):
        super().__init__(cfg, n_blocks, device)
        dt = cfg.compute_dtype
        self.syb_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, device)
        self.syb_mlp = _TwoLayerMLP(cfg.glove_dim, cfg.vis_fea_dim, cfg.hidden_size, dt, device)
        self.syb_positional_encoding = _seq_pe(cfg.maxlen, cfg, device)

    def forward(self, syb_ipt, syb_graph, generator=None):
        b, ls = syb_ipt.shape
        s = self.syb_mlp(self.syb_emb(syb_ipt))
        s = s + _seq_pe_rows(self.syb_positional_encoding, _positions(b, ls, s.device),
                            generator)
        return self.stack(s, syb_graph)


class _MILAlignJoint(nn.Module):
    """x5's alignment: a joint [vis ++ syb] GraphMask stack returning each
    block's attention weights."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, _enc_names(cfg.num_blocks), device,
                              return_att=True)

    def forward(self, vis_fea, syb_fea):
        fea = torch.cat([vis_fea, syb_fea], dim=1)
        att_weights = []
        for i in range(self.cfg.num_blocks):
            fea, att = getattr(self, f"enc_self_attention_{i}")(fea, fea, fea, None)
            fea = getattr(self, f"enc_feed_forward_{i}")(fea)
            att_weights.append(att)
        return fea, att_weights


class _QuestionPath(nn.Module):
    """The MIL line's question input: ``q_emb``, ``q_mlp`` and a positional
    table in a Sequential (dropped out in x5 only, as in the TPU package)."""

    def _build_question(self, cfg: ModelConfig, device, pe_dropout: bool) -> None:
        dt, h = cfg.compute_dtype, cfg.hidden_size
        self.q_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, device)
        self.q_mlp = _TwoLayerMLP(cfg.glove_dim, h, h, dt, device)
        self.q_positional_encoding = _seq_pe(cfg.maxlen_q, cfg, device, dropout=pe_dropout)

    def _question(self, q_ipt, generator):
        b, lq = q_ipt.shape
        q = self.q_mlp(self.q_emb(q_ipt))
        return q + _seq_pe_rows(self.q_positional_encoding, _positions(b, lq, q.device),
                                generator)


class X5DecMil(_QuestionPath):
    """x5: self stacks -> joint MIL alignment -> question-token decoder over
    the fused sequence, masked max-pool, one head. ``forward(vis_fea,
    vis_mask_1d, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d, syb_graph,
    generator=None)`` -> (logits, att_weights)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.att_vis = _VisFeaPath(cfg, cfg.num_blocks, dev)
        self.att_syb = _SybFeaPath(cfg, cfg.num_blocks, dev)
        self.MIL_align = _MILAlignJoint(cfg, dev)
        self._build_question(cfg, dev, pe_dropout=True)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, [
            (f"dec_vanilla_attention_{i}", f"dec_feed_forward_{i}")
            for i in range(cfg.num_blocks)], dev)
        self.cls = _Head(cfg, cfg.hidden_size, dev)

    def forward(self, vis_fea, vis_mask_1d, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d,
                syb_graph, generator: Optional[torch.Generator] = None):
        fea_vis = self.att_vis(vis_fea, generator)
        fea_syb = self.att_syb(syb_ipt, syb_graph, generator)
        fea, att_weights = self.MIL_align(fea_vis, fea_syb)
        mask = torch.cat([vis_mask_1d.float(), syb_mask_1d.float()], dim=1)
        fea = fea * mask[..., None].to(fea.dtype)
        dec = self._question(q_ipt, generator)
        for i in range(self.cfg.num_blocks):
            dec = getattr(self, f"dec_vanilla_attention_{i}")(dec, fea, fea, None)
            dec = getattr(self, f"dec_feed_forward_{i}")(dec)
        dec = dec * q_mask_1d.to(dec.dtype)[..., None]
        return self.cls(_max_pool_rows(dec), generator), att_weights


class X7DecMil(_QuestionPath):
    """x7: interleaved joint self-attention and vis->syb cross alignment per
    block, question tokens attending the aligned pair, a 1-token decoder
    over the question, one head. Its depths are the fork's constants (2-block
    self stacks, 3 alignment rounds, 4 blocks elsewhere), whatever
    ``num_blocks``. Returns (logits, att_weights)."""

    N_MAIN = 4
    N_ALIGN = 3

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.att_vis = _VisFeaPath(cfg, 2, dev)
        self.att_syb = _SybFeaPath(cfg, 2, dev)
        self.MIL_align = nn.Module()
        _attention_ffn_blocks(self.MIL_align, GraphMaskAttention, cfg,
                              _enc_names(self.N_ALIGN), dev)
        _attention_ffn_blocks(self.MIL_align, GraphMaskAttention, cfg,
                              _enc_names(self.N_ALIGN, "align_enc"), dev, return_att=True)
        self._build_question(cfg, dev, pe_dropout=False)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, [
            ("q_self_attention", "q_self_feed_forward"),
            ("gq_self_attention", "gq_self_feed_forward")], dev)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, _enc_names(self.N_MAIN), dev)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg, [
            (f"dec_vanilla_attention_{i}", f"dec_feed_forward_{i}")
            for i in range(self.N_MAIN)], dev)
        self.dec_emb = Embedding(2, cfg.hidden_size, zeros_pad=True, scale=True,
                                 dtype=cfg.compute_dtype, device=dev)
        self.cls = _Head(cfg, cfg.hidden_size, dev)

    def forward(self, vis_fea, vis_mask_1d, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d,
                syb_graph, generator: Optional[torch.Generator] = None):
        lv = vis_fea.shape[1]
        fea_vis = self.att_vis(vis_fea, generator)
        fea_syb = self.att_syb(syb_ipt, syb_graph, generator)
        al = self.MIL_align
        att_weights = []
        for i in range(self.N_ALIGN):
            joint = torch.cat([fea_vis, fea_syb], dim=1)
            joint = getattr(al, f"enc_self_attention_{i}")(joint, joint, joint, None)
            joint = getattr(al, f"enc_feed_forward_{i}")(joint)
            fea_vis, fea_syb = joint[:, :lv], joint[:, lv:]
            fea_vis, att = getattr(al, f"align_enc_self_attention_{i}")(
                fea_vis, fea_syb, fea_syb, None)
            fea_vis = getattr(al, f"align_enc_feed_forward_{i}")(fea_vis)
            att_weights.append(att)
        fea_vis = fea_vis * vis_mask_1d.to(fea_vis.dtype)[..., None]
        fea_syb = fea_syb * syb_mask_1d.to(fea_syb.dtype)[..., None]

        q = self._question(q_ipt, generator)
        q = self.q_self_feed_forward(self.q_self_attention(q, q, q, None))
        q = self.gq_self_feed_forward(self.gq_self_attention(q, q, q, q_graph))
        q = q * q_mask_1d.to(q.dtype)[..., None]
        fused = torch.cat([fea_vis, fea_syb], dim=1)
        for i in range(self.N_MAIN):
            q = getattr(self, f"enc_self_attention_{i}")(q, fused, fused, None)
            q = getattr(self, f"enc_feed_forward_{i}")(q)
        b = q.shape[0]
        dec = self.dec_emb(torch.ones(b, 1, dtype=torch.long, device=q.device))
        for i in range(self.N_MAIN):
            dec = getattr(self, f"dec_vanilla_attention_{i}")(dec, q, q, None)
            dec = getattr(self, f"dec_feed_forward_{i}")(dec)
        return self.cls(dec[:, 0], generator), att_weights


class X6DecMil(_QuestionPath):
    """x6: vis->syb cross alignment (2 blocks, the last one's weights kept),
    the aligned visual rows substituted into the symbolic sequence at
    ``idx_of_obj`` (-1 wraps to the last row, the fork's raw indexing; a
    later object slot overwrites an earlier one), then two staged
    (syb ++ q) encoders ``vq`` / ``sq`` each with a 1-token GraphMask
    decoder sharing one 2-row BOS table, concat head. ``forward(..., syb_graph,
    idx_of_obj, generator=None)`` -> (logits, att_weights)."""

    N_SELF = 2

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        n = cfg.num_blocks
        self.att_vis = _VisFeaPath(cfg, self.N_SELF, dev)
        self.att_syb = _SybFeaPath(cfg, self.N_SELF, dev)
        self.MIL_align = nn.Module()
        _attention_ffn_blocks(self.MIL_align, GraphMaskAttention, cfg, _enc_names(self.N_SELF),
                              dev, return_att=True)
        self._build_question(cfg, dev, pe_dropout=False)
        _attention_ffn_blocks(self, GraphMaskAttention, cfg,
                              [("q_self_attention", "q_self_feed_forward")], dev)
        self.dec_emb = Embedding(2, cfg.hidden_size, zeros_pad=True, scale=True,
                                 dtype=cfg.compute_dtype, device=dev)
        for br in ("vq", "sq"):
            _attention_ffn_blocks(self, GraphMaskAttention, cfg, _enc_names(n, f"{br}_enc"),
                                  dev)
            _attention_ffn_blocks(self, GraphMaskAttention, cfg, [
                (f"{br}_dec_vanilla_attention_{i}", f"{br}_dec_feed_forward_{i}")
                for i in range(n)], dev)
        self.cls = _Head(cfg, 2 * cfg.hidden_size, dev)

    def _staged_branch(self, name: str, seq, q, plan):
        fea = torch.cat([seq, q], dim=1)
        for i, g in enumerate(plan):
            fea = getattr(self, f"{name}_enc_self_attention_{i}")(fea, fea, fea, g)
            fea = getattr(self, f"{name}_enc_feed_forward_{i}")(fea)
        b = fea.shape[0]
        dec = self.dec_emb(torch.ones(b, 1, dtype=torch.long, device=fea.device))
        for i in range(self.cfg.num_blocks):
            dec = getattr(self, f"{name}_dec_vanilla_attention_{i}")(dec, fea, fea, None)
            dec = getattr(self, f"{name}_dec_feed_forward_{i}")(dec)
        return dec[:, 0]

    def forward(self, vis_fea, vis_mask_1d, q_ipt, q_mask_1d, q_graph, syb_ipt, syb_mask_1d,
                syb_graph, idx_of_obj, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        ls = syb_ipt.shape[1]
        fea_vis = self.att_vis(vis_fea, generator)
        fea_syb = self.att_syb(syb_ipt, syb_graph, generator)
        fv = fea_vis
        for i in range(self.N_SELF):
            fv, att = getattr(self.MIL_align, f"enc_self_attention_{i}")(
                fv, fea_syb, fea_syb, None)
            fv = getattr(self.MIL_align, f"enc_feed_forward_{i}")(fv)
        att_weights = [att]
        fv = fv * vis_mask_1d.to(fv.dtype)[..., None]

        n_obj = idx_of_obj.shape[1]
        rows = torch.where(idx_of_obj >= 0, idx_of_obj, idx_of_obj + ls).long()
        fea_syb_vis = _last_writer_put(fea_syb, rows, fv[:, :n_obj])

        q = self._question(q_ipt, generator)
        q = self.q_self_feed_forward(self.q_self_attention(q, q, q, None))
        q = q * q_mask_1d.to(q.dtype)[..., None]
        stages = _stage_graphs_1d(syb_mask_1d, q_mask_1d, q_graph, syb_graph, "x2",
                                  visual=False)
        plan = ([stages[0]] * cfg.stage1_blocks
                + [stages[1]] * (cfg.stage2_blocks - cfg.stage1_blocks)
                + [stages[2]] * (cfg.num_blocks - cfg.stage2_blocks))
        fused = torch.cat([self._staged_branch("vq", fea_syb_vis, q, plan),
                           self._staged_branch("sq", fea_syb, q, plan)], dim=1)
        return self.cls(fused, generator), att_weights


# ---------------------------------------------------------------- fusion_dec_mil line


class _MILAlignRef(nn.Module):
    """The fusion_dec_mil line's alignment stack: its own positions on the
    visual queries, then ``n_blocks`` graph-guided (L1) cross-attention
    blocks whose graph is the (B, Lq, 1) query-validity column, with live
    attention dropout (``cfg.dropout_rate``, the one module of the family
    that drops attention weights) and the weights returned. ``keep``
    'all' (mil) or 'last' (mil2)."""

    def __init__(self, cfg: ModelConfig, num_units: int, device, n_blocks: int = 3,
                 keep: str = "all"):
        super().__init__()
        self.n_blocks = n_blocks
        self.keep = keep
        self.syb_positional_encoding = _pe_table(cfg.maxlen, cfg, device, num_units)
        _attention_ffn_blocks(self, GraphGuidedAttention, cfg, _enc_names(n_blocks), device,
                              width=num_units, dropout_rate=cfg.dropout_rate, return_att=True)

    def forward(self, vis_fea, vis_valid, syb_fea, generator=None):
        b, lv = vis_fea.shape[:2]
        vis_fea = vis_fea + self.syb_positional_encoding(_positions(b, lv, vis_fea.device))
        att_weights = []
        for i in range(self.n_blocks):
            vis_fea, att = getattr(self, f"enc_self_attention_{i}")(
                vis_fea, syb_fea, syb_fea, vis_valid, generator)
            vis_fea = getattr(self, f"enc_feed_forward_{i}")(vis_fea)
            att_weights.append(att)
        return vis_fea, att_weights[-1:] if self.keep == "last" else att_weights


def _triple_heads(mod: nn.Module, cfg: ModelConfig, device) -> None:
    mod.cls = _Head(cfg, 2 * cfg.hidden_size, device)
    mod.cls_vis = _Head(cfg, cfg.hidden_size, device)
    mod.cls_syb = _Head(cfg, cfg.hidden_size, device)


class X2FusionDecMil(nn.Module):
    """fusion_dec_mil: split staged encoders, cross MIL alignment between
    the encoded sequences, then 1-token decoders; both branches decode
    through the one *visual* decoder (the reference's quirk: there is
    ``att_vis_dec`` and no ``att_syb_dec``). ``forward`` as X2DecModel's
    -> (logits_concat, logits_vis, logits_syb, att_weights)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.att_vis_enc = _StagedEncoderOnly(cfg, cfg.maxlen, ids_input=False, device=dev,
                                              pe_sequential=True)
        self.att_syb_enc = _StagedEncoderOnly(cfg, cfg.maxlen + cfg.maxlen_q, ids_input=True,
                                              device=dev)
        self.MIL_align = _MILAlignRef(cfg, cfg.hidden_size, dev, keep="all")
        self.att_vis_dec = _OneTokenDecoder(cfg, cfg.maxlen, dev)
        _triple_heads(self, cfg, dev)

    def forward(self, vis_fea, vis_mask, q_ipt, q_mask, q_graph, syb_ipt, syb_mask, syb_graph,
                vis_graph=None, generator: Optional[torch.Generator] = None):
        fea_vis, dec_mask_vis = self.att_vis_enc(vis_fea, vis_mask, vis_graph, q_ipt, q_graph,
                                                 q_mask, generator)
        fea_syb, dec_mask_syb = self.att_syb_enc(syb_ipt, syb_mask, syb_graph, q_ipt, q_graph,
                                                 q_mask, generator)
        # the encoded [vis ++ q] rows' validity column (dec_mask transposed)
        fea_vis_align, att_weights = self.MIL_align(fea_vis, dec_mask_vis.transpose(1, 2),
                                                    fea_syb, generator)
        dec_vis = self.att_vis_dec(fea_vis_align, dec_mask_vis, generator)
        dec_syb = self.att_vis_dec(fea_syb, dec_mask_syb, generator)   # same weights (quirk)
        fused = torch.cat([dec_vis[:, 0], dec_syb[:, 0]], dim=1)
        return (self.cls(fused, generator), self.cls_vis(dec_vis, generator)[:, 0],
                self.cls_syb(dec_syb, generator)[:, 0], att_weights)


class X2FusionDecMil2(X2DecModel):
    """fusion_dec_mil2: align the raw region features against embedded
    symbolic nodes (a bare ``syb_mlp0``) before the dual encoders, at the
    region width, keeping only the last block's weights; the aligned
    features then feed the fusion_dec body (triple heads, bare-Linear
    projections, a bare visual positional table). Returns (logits_concat,
    logits_vis, logits_syb, att_weights)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, heads="triple", mlp_relu=False, device=device,
                         vis_pe_sequential=False)
        dev = resolve_device(device)
        dt = cfg.compute_dtype
        self.syb_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, dev)
        self.syb_mlp0 = Linear(cfg.glove_dim, cfg.vis_fea_dim, dt, dev)
        self.MIL_align = _MILAlignRef(cfg, cfg.vis_fea_dim, dev, keep="last")

    def forward(self, vis_fea, vis_mask, q_ipt, q_mask, q_graph, syb_ipt, syb_mask, syb_graph,
                vis_graph=None, generator: Optional[torch.Generator] = None):
        fea_syb_emb = self.syb_mlp0(self.syb_emb(syb_ipt))
        vis_valid = (vis_mask.float().sum(dim=2) > 0).float()[..., None]
        fea_vis_align, att_weights = self.MIL_align(vis_fea.to(self.cfg.compute_dtype),
                                                    vis_valid, fea_syb_emb, generator)
        out = super().forward(fea_vis_align, vis_mask, q_ipt, q_mask, q_graph, syb_ipt,
                              syb_mask, syb_graph, vis_graph=vis_graph, generator=generator)
        return out + (att_weights,)


class _RelattVisBranch(_StagedEncoderOnly):
    """relatt's ``att_vis``: the staged encoder over the vis-symbolic node
    graph, raw region features substituted into the object-node rows, and
    its 1-token decoder."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, cfg.maxlen, ids_input=False, device=device)
        _OneTokenDecoder.build(self, cfg, cfg.maxlen, device)

    def forward(self, vis_fea, vis_syb_ipt, vis_syb_mask, vis_syb_link, vis_syb_graph, q_ipt,
                q_mask, q_graph, generator=None):
        n_nodes = vis_syb_ipt.shape[1]
        fea = self.syb_mlp(self.syb_emb(torch.cat([vis_syb_ipt, q_ipt], dim=1)))
        # the j-th link-valid node row takes region j (the reference assigns
        # sequentially, not by the link's value)
        valid = vis_syb_link >= 0
        rank = (valid.long().cumsum(dim=1) - 1).clamp(0, vis_fea.shape[1] - 1)
        subst = torch.gather(vis_fea, 1, rank[..., None].expand(-1, -1, vis_fea.shape[2]))
        node_part = torch.where(valid[..., None], subst.to(fea.dtype), fea[:, :n_nodes])
        fea = self.syb_mlp2(torch.cat([node_part, fea[:, n_nodes:]], dim=1))
        fea, dec_mask = self.encode(fea, vis_syb_mask, vis_syb_graph, q_graph, q_mask,
                                    generator)
        return _OneTokenDecoder.decode(self, fea, dec_mask, generator)


class X2FusionDecRelatt(nn.Module):
    """fusion_dec_relatt: the visual branch runs over the vis-symbolic node
    graph with region features substituted into its object-node rows
    (``vis_syb_link`` (B, N): the region of each node row, -1 where none);
    symbolic branch and triple heads as in the x2_dec line.
    ``vis_graph_enabled=False`` makes the node block fully connected.
    Returns (logits_concat, logits_vis, logits_syb)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.att_vis = _RelattVisBranch(cfg, dev)
        self.att_syb = _StagedEncoderDecoder(cfg, cfg.maxlen + cfg.maxlen_q, ids_input=True,
                                             device=dev)
        _triple_heads(self, cfg, dev)

    def forward(self, vis_fea, vis_syb_ipt, vis_syb_mask, vis_syb_link, vis_syb_graph, q_ipt,
                q_mask, q_graph, syb_ipt, syb_mask, syb_graph, vis_graph_enabled: bool = True,
                generator: Optional[torch.Generator] = None):
        fea_vis = self.att_vis(vis_fea, vis_syb_ipt, vis_syb_mask, vis_syb_link,
                               vis_syb_graph if vis_graph_enabled else None, q_ipt, q_mask,
                               q_graph, generator)
        fea_syb = self.att_syb(syb_ipt, syb_mask, syb_graph, q_ipt, q_graph, q_mask, generator)
        fused = torch.cat([fea_syb[:, 0], fea_vis[:, 0]], dim=1)
        return (self.cls(fused, generator), self.cls_vis(fea_vis, generator)[:, 0],
                self.cls_syb(fea_syb, generator)[:, 0])


# --------------------------------------------------------------------------- x3_ori

PAD_ID = 400000   # the relation candidates' padding id


class _MILNCELoop(nn.Module):
    """x3_ori's MIL-NCE, the batch-loop precursor of ``MILNCEModule``.

    Its semantics differ from the production module's and are kept: the
    object term is the sum over the batch of per-sample ``log(sum mask
    e^pos / (sum mask e^pos + sum mask e^neg))`` (raw exp, no logsumexp);
    relation candidates index a per-pair bilinear score ``x_i^T W_r x_j``
    over all relations, softmaxed over relations, PAD candidates skipped;
    every ordered object pair (i != j) writes ``rel_mlp(new_rel_fea)`` into
    its macro row in pair order, later pairs overwriting earlier ones, a
    negative ``macro_rel_loc`` wrapping to the end; the macro embeddings are
    detached. The writes are made once, each row by its last writer
    (:func:`_last_writer_put`). A pair whose candidates are all PAD adds 0
    to the relation term, with a zero gradient.
    """

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, h = cfg.compute_dtype, cfg.hidden_size_mil
        self.cfg = cfg
        self.syb_emb = GloVeEmbed(cfg.vocab_size, cfg.glove_dim, dt, device)
        self.marco_mlp = linear_relu(cfg.glove_dim, h, dt, device)
        self.syb_mlp = linear_relu(cfg.glove_dim, h, dt, device)
        self.vis_mlp = linear_relu(cfg.vis_fea_dim, h, dt, device)
        self.bilinear = nn.ParameterDict({"weight": nn.Parameter(
            nn.init.xavier_normal_(torch.empty(cfg.num_relations, h, h, device=device)))})
        self.rel_mlp = _TwoLayerMLP(h, h, 1, dt, device)
        self.ipt_mlp = linear_relu(h, cfg.vis_fea_dim, dt, device)

    def forward(self, vis_fea, macro_ipt, macro_obj_loc, macro_rel_loc, micro_pos_obj,
                micro_neg_obj, micro_obj_mask, micro_pos_rel, micro_neg_rel):
        cfg = self.cfg
        b, ls = macro_ipt.shape
        o = vis_fea.shape[1]
        n_rel = cfg.num_relations
        glove = self.syb_emb
        new_macro = self.marco_mlp(glove(macro_ipt)).detach()

        pos_fea = self.syb_mlp(glove(micro_pos_obj))          # (B, O, T, h)
        neg_fea = self.syb_mlp(glove(micro_neg_obj))
        vis_emb = self.vis_mlp(vis_fea.to(cfg.compute_dtype))  # (B, O, h)
        pos_scores = torch.einsum("both,boh->bot", pos_fea.float(), vis_emb.float())
        neg_scores = torch.einsum("both,boh->bot", neg_fea.float(), vis_emb.float())
        m = micro_obj_mask.float()
        nume = (m * pos_scores.exp()).sum(dim=(1, 2))
        deno = nume + (m * neg_scores.exp()).sum(dim=(1, 2))
        mil_obj = (nume / deno).log().sum()

        w = torch.softmax(pos_scores, dim=2).to(pos_fea.dtype)
        new_obj = (w[..., None] * pos_fea).sum(dim=2)         # (B, O, h)
        obj_rows = torch.where(macro_obj_loc >= 0, macro_obj_loc,
                               torch.full_like(macro_obj_loc, ls)).long()
        new_macro = _last_writer_put(new_macro, obj_rows, new_obj)

        # relations over every ordered pair, in the reference's pair order
        w_rel = self.bilinear["weight"]
        pi, pj = (t.to(vis_fea.device) for t in torch.nonzero(
            ~torch.eye(o, dtype=torch.bool), as_tuple=True))
        n_pairs = pi.numel()
        xi, xj = new_obj[:, pi].float(), new_obj[:, pj].float()   # (B, P, h)
        outer = (xi[..., :, None] * xj[..., None, :]).reshape(b, n_pairs, -1)
        rels = outer @ w_rel.reshape(n_rel, -1).t()               # (B, P, R)
        sm = torch.softmax(rels, dim=-1)

        p_cand, n_cand = micro_pos_rel[:, :n_pairs], micro_neg_rel[:, :n_pairs]
        vf = (p_cand != PAD_ID).float()
        cp = p_cand.clamp(0, n_rel - 1).long()
        cn = n_cand.clamp(0, n_rel - 1).long()
        nume_r = (vf * torch.gather(rels, -1, cp).exp()).sum(dim=-1)
        deno_r = nume_r + (vf * torch.gather(rels, -1, cn).exp()).sum(dim=-1)
        live = deno_r > 0.0
        ratio = torch.where(live, nume_r / deno_r.clamp_min(1e-30), torch.ones_like(nume_r))
        mil_rel = torch.where(live, ratio.log(), torch.zeros_like(ratio)).sum()

        # the softmax weight of each positive candidate's relation, summed
        # per relation: coeff (B, P, R), then new_rel_fea = coeff . W
        wp = torch.gather(sm, -1, cp) * vf
        coeff = torch.zeros_like(sm).scatter_add_(-1, cp, wp)
        new_rel_fea = (coeff @ w_rel.reshape(n_rel, -1)).reshape(b, n_pairs, *w_rel.shape[1:])
        rel_out = self.rel_mlp(new_rel_fea.to(cfg.compute_dtype))[..., 0]   # (B, P, h)

        loc = macro_rel_loc[:, :n_pairs]
        rel_rows = torch.where(loc >= 0, loc, loc + ls).long()
        new_macro = _last_writer_put(new_macro, rel_rows, rel_out)
        return self.ipt_mlp(new_macro), mil_obj, mil_rel


class X3OriModel(nn.Module):
    """AttModel_x3_ori: the x3 body with maxlen-sized symbolic positional
    tables, no visual graph input, and the batch-loop MIL. Returns
    (logits_concat, logits_vis, logits_syb, mil_obj, mil_rel)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.MIL_NCE = _MILNCELoop(cfg, dev)
        self.att_vis_grid = _Branch(cfg, cfg.maxlen, pe_dropout=True, glove=None, device=dev)
        self.att_syb = _Branch(cfg, cfg.maxlen, pe_dropout=False, glove=None, device=dev)
        _triple_heads(self, cfg, dev)

    def forward(self, vis_fea, vis_mask, q_ipt, q_mask, q_graph, macro_ipt, macro_mask,
                macro_graph, macro_obj_loc, macro_rel_loc, micro_pos_obj, micro_neg_obj,
                micro_obj_mask, micro_pos_rel, micro_neg_rel,
                generator: Optional[torch.Generator] = None):
        new_macro, mil_obj, mil_rel = self.MIL_NCE(
            vis_fea, macro_ipt, macro_obj_loc, macro_rel_loc, micro_pos_obj, micro_neg_obj,
            micro_obj_mask, micro_pos_rel, micro_neg_rel)
        fea_vis = self.att_vis_grid(vis_fea, vis_mask, None, q_ipt, q_graph, q_mask, generator)
        fea_syb = self.att_syb(new_macro, macro_mask, macro_graph, q_ipt, q_graph, q_mask,
                               generator)
        fused = torch.cat([fea_syb[:, 0], fea_vis[:, 0]], dim=1)
        return (self.cls(fused, generator), self.cls_vis(fea_vis, generator)[:, 0],
                self.cls_syb(fea_syb, generator)[:, 0], mil_obj, mil_rel)


# ---- registry: reference model name -> (class, kwargs) --------------------------

VARIANTS = {
    "x": (MaxPoolDualEncoder, {"stage_style": "x"}),
    "x2": (MaxPoolDualEncoder, {"stage_style": "x2"}),
    "x2_pre": (MaxPoolDualEncoder, {"stage_style": "x2"}),   # byte-identical fork
    "x2_distill": (MaxPoolDualEncoder, {"stage_style": "x2_distill"}),
    "x2_dec": (X2DecModel, {"heads": "single", "mlp_relu": False}),
    "x2_dec_ori": (X2DecOriModel, {}),
    "x2_mlp_dec": (X2DecModel, {"heads": "single", "vis_v_mlp": True, "dec_cross": "vanilla"}),
    "x2_syb_dec": (X2DecModel, {"heads": "triple", "mlp_relu": False}),   # = x2_fusion_dec
    "x2_fusion_dec": (X2DecModel, {"heads": "triple", "mlp_relu": False}),
    "x2_fusion_dec_relatt": (X2FusionDecRelatt, {}),
    "x2_fusion_dec_mil": (X2FusionDecMil, {}),
    "x2_fusion_dec_mil2": (X2FusionDecMil2, {}),
    "x3_ori": (X3OriModel, {}),
    "x4_dec": (X4DecModel, {}),
    "x5_dec_mil": (X5DecMil, {}),
    "x6_dec_mil": (X6DecMil, {}),
    "x7_dec_mil": (X7DecMil, {}),
}


def build_variant(name: str, cfg: ModelConfig, device=None) -> nn.Module:
    """An ablation model by its reference name (e.g. 'x2_dec'); 'x3' and
    'v3' give the production ``AttModelX3``. On the card unless ``device``
    says otherwise."""
    if name in ("x3", "v3"):
        from structured_alignment_vqa_tpu_torch.models.att_model_x3 import AttModelX3

        return AttModelX3(cfg, device=device)
    cls, kw = VARIANTS[name]
    return cls(cfg, device=device, **kw)
