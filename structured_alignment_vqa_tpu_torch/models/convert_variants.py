"""Carry the ablation variants' weights from a JAX ``params`` tree into the
port (``models/variants.py``).

:func:`variant_name_map` is a list of ``(torch name, JAX param path,
transpose)`` entries, in the shape of ``models/convert.py:name_map``: the
torch names are the reference forks' state-dict names, which the port's
modules carry; a flax ``Dense.kernel`` (in, out) becomes ``Linear.weight``
(out, in). Where the TPU package keeps one flax scope for what the
reference holds in two torch modules (or the other way round) the map says
so entry by entry: x4_dec's flat ``vis_*``/``syb_*`` scopes become
``att_vis_grid.*``/``att_syb.*``, the x fork's stage-2 blocks
``enc_self_attention_{n//2 + j}`` become ``enc_self_attention_graph_j``,
x7's ``align_joint_i``/``align_cross_i`` become ``MIL_align.*``, relatt's
``att_syb_enc`` and ``att_syb_dec`` both become ``att_syb``. Tables keep
the TPU package's sizes.

This module reads numpy arrays only; it imports no JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from structured_alignment_vqa_tpu_torch.models.config import ModelConfig

Entry = Tuple[str, Tuple[str, ...], bool]


def _dense(t: str, f: tuple) -> List[Entry]:
    return [(f"{t}.weight", f + ("kernel",), True), (f"{t}.bias", f + ("bias",), False)]


def _mlp2(t: str, f: tuple, relu: bool = True) -> List[Entry]:
    """A two-layer MLP: ``Sequential(Linear, ReLU, Linear)`` (``.0``/``.2``)
    or, without the ReLU, ``Sequential(Linear, Linear)`` (``.0``/``.1``)."""
    return _dense(f"{t}.0", f + ("fc1",)) + _dense(f"{t}.{2 if relu else 1}", f + ("fc2",))


def _ln(t: str, f: tuple) -> List[Entry]:
    return [(f"{t}.normalization.gamma", f + ("ln", "gamma"), False),
            (f"{t}.normalization.beta", f + ("ln", "beta"), False)]


def _att(t: str, f: tuple) -> List[Entry]:
    out = []
    for ref, here in (("Q_proj", "q_proj"), ("K_proj", "k_proj"), ("V_proj", "v_proj")):
        out += _dense(f"{t}.{ref}.0", f + (here,))
    return out + _ln(t, f)


def _ffn(t: str, f: tuple) -> List[Entry]:
    return _dense(f"{t}.conv1.0", f + ("fc1",)) + _dense(f"{t}.conv2", f + ("fc2",)) + _ln(t, f)


def _block(t_att: str, t_ffn: str, f_att: tuple, f_ffn: tuple) -> List[Entry]:
    return _att(t_att, f_att) + _ffn(t_ffn, f_ffn)


def _enc(t: str, f: tuple, n: int, start: int = 0) -> List[Entry]:
    """``enc_self_attention_i``/``enc_feed_forward_i`` for i in [start, n)
    on both sides."""
    out = []
    for i in range(start, n):
        out += _block(f"{t}enc_self_attention_{i}", f"{t}enc_feed_forward_{i}",
                      f + (f"enc_self_attention_{i}",), f + (f"enc_feed_forward_{i}",))
    return out


def _table(t: str, f: tuple) -> List[Entry]:
    return [(f"{t}.lookup_table", f + ("lookup_table",), False)]


def _glove(t: str, f: tuple) -> List[Entry]:
    return [(f"{t}.weight", f + ("table",), False)]


def _head(t: str, prefix: str, f: tuple = ()) -> List[Entry]:
    return _dense(f"{t}.0", f + (f"{prefix}_hidden",)) + _dense(f"{t}.3", f + (f"{prefix}_out",))


def _heads(triple: bool, f: tuple = ()) -> List[Entry]:
    names = ("cls", "cls_vis", "cls_syb") if triple else ("cls",)
    return [e for n in names for e in _head(n, n, f)]


def _dec_stack(t: str, f: tuple, n: int, dec_emb: tuple = ("dec_emb",),
               dec_pe: tuple = ("dec_positional_encoding",), prefix: str = "") -> List[Entry]:
    """A 1-token decoder: its tables and per block self-attention,
    cross-attention and FFN (flax names ``{prefix}dec_*``)."""
    out = _table(f"{t}dec_emb", f + dec_emb) + _table(f"{t}dec_positional_encoding", f + dec_pe)
    for i in range(n):
        for mod in ("dec_self_attention", "dec_vanilla_attention"):
            out += _att(f"{t}{mod}_{i}", f + (f"{prefix}{mod}_{i}",))
        out += _ffn(f"{t}dec_feed_forward_{i}", f + (f"{prefix}dec_feed_forward_{i}",))
    return out


def _encoder_decoder(t: str, f: tuple, n: int, mlp: str, relu: bool, pe_seq: bool
                     ) -> List[Entry]:
    """One ``_Branch`` (the TPU package's ``_EncoderDecoder`` at ``f``)
    without its GloVe table."""
    proj = f"{t}.{mlp}.0" if relu else f"{t}.{mlp}"
    pe = f"{t}.syb_positional_encoding" + (".0" if pe_seq else "")
    out = _dense(proj, f + ("syb_mlp",)) + _dense(f"{t}.syb_mlp2", f + ("syb_mlp2",))
    out += _table(pe, f + ("syb_positional_encoding",))
    for i in range(n):
        out += _block(f"{t}.enc_self_attention_{i}", f"{t}.enc_feed_forward_{i}",
                      f + (f"block_{i}", f"enc_self_attention_{i}"),
                      f + (f"block_{i}", f"enc_feed_forward_{i}"))
    return out + _dec_stack(f"{t}.", f, n)


def _max_pool(cfg: ModelConfig, style: str) -> List[Entry]:
    n, half = cfg.num_blocks, cfg.num_blocks // 2
    out = _glove("q_emb", ("q_emb",)) + _glove("att_syb.syb_emb", ("syb_emb",)) + _heads(False)
    out += _mlp2("att_vis_grid.v_mlp", ("v_mlp",)) + _mlp2("att_syb.syb_mlp", ("syb_mlp",))
    for br, pe in (("att_vis_grid", "v_positional_encoding"),
                   ("att_syb", "syb_positional_encoding")):
        f = (br,)
        out += _mlp2(f"{br}.q_mlp", f + ("q_mlp",))
        out += _table(f"{br}.q_positional_encoding.0", f + ("q_positional_encoding",))
        out += _table(f"{br}.{pe}.0", f + ("positional_encoding",))
        if style == "x":
            out += _enc(f"{br}.", f, half)
            for j in range(n - half):
                out += _block(f"{br}.enc_self_attention_graph_{j}",
                              f"{br}.enc_feed_forward_graph_{j}",
                              f + (f"enc_self_attention_{half + j}",),
                              f + (f"enc_feed_forward_{half + j}",))
        else:
            # the symbolic branch's blocks past stage 2 that its final stage
            # does not re-run are never called, and neither side builds them
            used = n if br == "att_vis_grid" else max(cfg.stage2_blocks, half)
            out += _enc(f"{br}.", f, used)
    return out


def _x2_dec(cfg: ModelConfig, heads: str = "single", mlp_relu: bool = True,
            vis_v_mlp: bool = False, f: tuple = (), vis_pe_sequential: bool = True
            ) -> List[Entry]:
    n = cfg.num_blocks
    mlp = "syb_mlp_sequence" if mlp_relu else "syb_mlp"
    if cfg.share_glove:
        out = _glove("att_vis_grid.syb_emb", f + ("glove",))
        out += _glove("att_syb.syb_emb", f + ("glove",))
    else:
        out = _glove("att_vis_grid.syb_emb", f + ("vis_syb_emb",))
        out += _glove("att_syb.syb_emb", f + ("syb_syb_emb",))
    if vis_v_mlp:
        out += _dense("att_vis_grid.v_mlp.0", f + ("v_mlp",))
    out += _encoder_decoder("att_vis_grid", f + ("att_vis_grid",), n, mlp, mlp_relu,
                            vis_pe_sequential)
    out += _mlp2(f"att_syb.{mlp}", f + ("syb_mlp",), relu=mlp_relu)
    out += _table("att_syb.syb_positional_encoding", f + ("syb_positional_encoding",))
    for i in range(n):
        out += _block(f"att_syb.enc_self_attention_{i}", f"att_syb.enc_feed_forward_{i}",
                      f + (f"syb_enc_self_attention_{i}",), f + (f"syb_enc_feed_forward_{i}",))
    out += _dec_stack("att_syb.", f, n, ("syb_dec_emb",), ("syb_dec_positional_encoding",),
                      prefix="syb_")
    return out + _heads(heads == "triple", f)


def _dec_ori(cfg: ModelConfig, flat: bool) -> List[Entry]:
    """x2_dec_ori (flax scopes ``att_vis_grid``/``att_syb``) or x4_dec
    (flat ``vis_*``/``syb_*`` names); the torch names are the same."""
    n = cfg.num_blocks
    out = _glove("q_emb", ("q_emb",)) + _glove("att_syb.syb_emb", ("syb_emb",)) + _heads(False)
    out += _mlp2("att_vis_grid.v_mlp", ("v_mlp",)) + _mlp2("att_syb.syb_mlp", ("syb_mlp",))
    for br, short, pe in (("att_vis_grid", "vis", "v_positional_encoding"),
                          ("att_syb", "syb", "syb_positional_encoding")):
        f, p = ((), f"{short}_") if flat else ((br,), "")
        out += _mlp2(f"{br}.q_mlp", f + (f"{p}q_mlp",))
        out += _table(f"{br}.q_positional_encoding.0", f + (f"{p}q_positional_encoding",))
        out += _table(f"{br}.{pe}.0", f + (f"{p}positional_encoding",))
        out += _table(f"{br}.dec_emb", f + (f"{p}dec_emb",))
        for i in range(n):
            out += _block(f"{br}.enc_self_attention_{i}", f"{br}.enc_feed_forward_{i}",
                          f + (f"{p}enc_self_attention_{i}",), f + (f"{p}enc_feed_forward_{i}",))
            out += _block(f"{br}.dec_vanilla_attention_{i}", f"{br}.dec_feed_forward_{i}",
                          f + (f"{p}dec_vanilla_attention_{i}",),
                          f + (f"{p}dec_feed_forward_{i}",))
    return out


def _mil_paths(n_self: int) -> List[Entry]:
    """att_vis / att_syb (feature paths and self stacks), the question path
    and the head of the x5/x6/x7 line."""
    out = _mlp2("att_vis.v_mlp", ("att_vis", "v_mlp"))
    out += _table("att_vis.v_positional_encoding.0", ("att_vis", "v_positional_encoding"))
    out += _glove("att_syb.syb_emb", ("att_syb", "syb_emb"))
    out += _mlp2("att_syb.syb_mlp", ("att_syb", "syb_mlp"))
    out += _table("att_syb.syb_positional_encoding.0", ("att_syb", "syb_positional_encoding"))
    out += _enc("att_vis.", ("att_vis_stack",), n_self) + _enc("att_syb.", ("att_syb_stack",),
                                                                n_self)
    out += _glove("q_emb", ("q_emb",)) + _mlp2("q_mlp", ("q_mlp",))
    out += _table("q_positional_encoding.0", ("q_positional_encoding",))
    return out + _heads(False)


def _x5(cfg: ModelConfig) -> List[Entry]:
    n = cfg.num_blocks
    out = _mil_paths(n) + _enc("MIL_align.", ("MIL_align",), n)
    for i in range(n):
        out += _block(f"dec_vanilla_attention_{i}", f"dec_feed_forward_{i}",
                      (f"dec_vanilla_attention_{i}",), (f"dec_feed_forward_{i}",))
    return out


def _x7(cfg: ModelConfig) -> List[Entry]:
    out = _mil_paths(2) + _table("dec_emb", ("dec_emb",))
    for i in range(3):
        out += _block(f"MIL_align.enc_self_attention_{i}", f"MIL_align.enc_feed_forward_{i}",
                      (f"align_joint_{i}",), (f"align_joint_ffn_{i}",))
        out += _block(f"MIL_align.align_enc_self_attention_{i}",
                      f"MIL_align.align_enc_feed_forward_{i}",
                      (f"align_cross_{i}",), (f"align_cross_ffn_{i}",))
    for q in ("q", "gq"):
        out += _block(f"{q}_self_attention", f"{q}_self_feed_forward",
                      (f"{q}_self_attention",), (f"{q}_self_feed_forward",))
    out += _enc("", (), 4)
    for i in range(4):
        out += _block(f"dec_vanilla_attention_{i}", f"dec_feed_forward_{i}",
                      (f"dec_vanilla_attention_{i}",), (f"dec_feed_forward_{i}",))
    return out


def _x6(cfg: ModelConfig) -> List[Entry]:
    out = _mil_paths(2) + _table("dec_emb", ("dec_emb",))
    for i in range(2):
        out += _block(f"MIL_align.enc_self_attention_{i}", f"MIL_align.enc_feed_forward_{i}",
                      (f"align_cross_{i}",), (f"align_cross_ffn_{i}",))
    out += _block("q_self_attention", "q_self_feed_forward",
                  ("q_self_attention",), ("q_self_feed_forward",))
    for br in ("vq", "sq"):
        for i in range(cfg.num_blocks):
            for kind in ("enc_self_attention", "dec_vanilla_attention"):
                out += _att(f"{br}_{kind}_{i}", (f"{br}_{kind}_{i}",))
            for kind in ("enc_feed_forward", "dec_feed_forward"):
                out += _ffn(f"{br}_{kind}_{i}", (f"{br}_{kind}_{i}",))
    return out


def _mil_align(f: tuple = ("MIL_align",), n: int = 3) -> List[Entry]:
    return _table("MIL_align.syb_positional_encoding", f + ("syb_positional_encoding",)) + _enc(
        "MIL_align.", f, n)


def _fusion_mil(cfg: ModelConfig) -> List[Entry]:
    n = cfg.num_blocks
    out = _glove("att_vis_enc.syb_emb", ("vis_syb_emb",))
    out += _glove("att_syb_enc.syb_emb", ("syb_syb_emb",))
    out += _dense("att_vis_enc.syb_mlp", ("att_vis_enc", "syb_mlp"))
    out += _dense("att_vis_enc.syb_mlp2", ("att_vis_enc", "syb_mlp2"))
    out += _table("att_vis_enc.syb_positional_encoding.0",
                  ("att_vis_enc", "syb_positional_encoding"))
    out += _enc("att_vis_enc.", ("att_vis_enc",), n)
    out += _mlp2("att_syb_enc.syb_mlp", ("att_syb_enc", "syb_mlp"), relu=False)
    out += _table("att_syb_enc.syb_positional_encoding",
                  ("att_syb_enc", "syb_positional_encoding"))
    out += _enc("att_syb_enc.", ("att_syb_enc",), n)
    out += _mil_align() + _dec_stack("att_vis_dec.", ("att_vis_dec",), n)
    return out + _heads(True)


def _fusion_mil2(cfg: ModelConfig) -> List[Entry]:
    out = _glove("syb_emb", ("syb_emb",)) + _dense("syb_mlp0", ("syb_mlp0",)) + _mil_align()
    return out + _x2_dec(cfg, "triple", mlp_relu=False, f=("body",), vis_pe_sequential=False)


def _relatt(cfg: ModelConfig) -> List[Entry]:
    n = cfg.num_blocks
    out = _glove("att_vis.syb_emb", ("vis_syb_emb",))
    out += _dense("att_vis.syb_mlp", ("syb_mlp",)) + _dense("att_vis.syb_mlp2", ("syb_mlp2",))
    out += _table("att_vis.syb_positional_encoding", ("syb_positional_encoding",))
    out += _enc("att_vis.", (), n) + _dec_stack("att_vis.", ("att_vis_dec",), n)
    out += _glove("att_syb.syb_emb", ("syb_syb_emb",))
    out += _mlp2("att_syb.syb_mlp", ("att_syb_enc", "syb_mlp"), relu=False)
    out += _table("att_syb.syb_positional_encoding", ("att_syb_enc", "syb_positional_encoding"))
    out += _enc("att_syb.", ("att_syb_enc",), n) + _dec_stack("att_syb.", ("att_syb_dec",), n)
    return out + _heads(True)


def _x3_ori(cfg: ModelConfig) -> List[Entry]:
    n = cfg.num_blocks
    f = ("mil_nce",)
    out = _glove("MIL_NCE.syb_emb", f + ("syb_emb",))
    for mod in ("marco_mlp", "syb_mlp", "vis_mlp", "ipt_mlp"):
        out += _dense(f"MIL_NCE.{mod}.0", f + (mod,))
    out += _dense("MIL_NCE.rel_mlp.0", f + ("rel_mlp_fc1",))
    out += _dense("MIL_NCE.rel_mlp.2", f + ("rel_mlp_fc2",))
    out.append(("MIL_NCE.bilinear.weight", f + ("bilinear",), False))
    out += _glove("att_vis_grid.syb_emb", ("vis_syb_emb",))
    out += _glove("att_syb.syb_emb", ("syb_syb_emb",))
    out += _encoder_decoder("att_vis_grid", ("att_vis_grid",), n, "syb_mlp", True, True)
    out += _encoder_decoder("att_syb", ("att_syb",), n, "syb_mlp", True, False)
    return out + _heads(True)


def variant_name_map(name: str, cfg: ModelConfig) -> List[Entry]:
    """(torch name, JAX param path, transpose) of every parameter of the
    variant ``name`` (a key of ``models/variants.VARIANTS``) at ``cfg``."""
    family = {
        "x": lambda: _max_pool(cfg, "x"),
        "x2": lambda: _max_pool(cfg, "x2"),
        "x2_pre": lambda: _max_pool(cfg, "x2"),
        "x2_distill": lambda: _max_pool(cfg, "x2_distill"),
        "x2_dec": lambda: _x2_dec(cfg, "single", mlp_relu=False),
        "x2_mlp_dec": lambda: _x2_dec(cfg, "single", mlp_relu=True, vis_v_mlp=True),
        "x2_syb_dec": lambda: _x2_dec(cfg, "triple", mlp_relu=False),
        "x2_fusion_dec": lambda: _x2_dec(cfg, "triple", mlp_relu=False),
        "x2_dec_ori": lambda: _dec_ori(cfg, flat=False),
        "x4_dec": lambda: _dec_ori(cfg, flat=True),
        "x5_dec_mil": lambda: _x5(cfg),
        "x6_dec_mil": lambda: _x6(cfg),
        "x7_dec_mil": lambda: _x7(cfg),
        "x2_fusion_dec_mil": lambda: _fusion_mil(cfg),
        "x2_fusion_dec_mil2": lambda: _fusion_mil2(cfg),
        "x2_fusion_dec_relatt": lambda: _relatt(cfg),
        "x3_ori": lambda: _x3_ori(cfg),
    }
    if name not in family:
        raise KeyError(f"unknown variant {name!r}")
    return family[name]()


def _get(tree: dict, path) -> np.ndarray:
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node)


def variant_state_dict_from_jax(name: str, params: Dict, cfg: ModelConfig
                                ) -> Dict[str, torch.Tensor]:
    """The port's float32 state dict (CPU tensors) of variant ``name`` from
    ``variables["params"]`` of the TPU package's model at ``cfg``; it loads
    into ``build_variant(name, cfg)`` with ``strict=True``. A path the tree
    lacks raises ``KeyError``."""
    out = {}
    for tname, path, transpose in variant_name_map(name, cfg):
        val = _get(params, path)
        # np.array copies: JAX hands out read-only buffers
        out[tname] = torch.from_numpy(np.array(val.T if transpose else val, dtype=np.float32,
                                               order="C"))
    return out
