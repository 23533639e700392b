"""Carry AttModelX3 weights from a JAX ``params`` tree into the port.

The JAX tree (nested dicts of numpy arrays, as ``jax.device_get`` returns
it) is mapped onto the reference's torch state-dict names, which the port's
modules carry. The name map is the port's own copy of the TPU package's
``models/torch_import.py:name_map``:

* flax ``Dense.kernel`` (in, out) becomes ``Linear.weight`` (out, in);
* the visual branch's positional encoding sits in a Sequential
  (``...syb_positional_encoding.0.lookup_table``), the symbolic branch's is
  bare;
* with ``share_glove`` the one ``glove/table`` fills all three
  ``syb_emb.weight`` slots (one shared module in the port).

An ``int8_serving`` tree (the TPU package's ``quantize_params``) maps the
same way, dtypes kept: ``.../table_q`` and ``table_scale`` become
``...syb_emb.weight_q`` (int8) and ``weight_scale``; a head's ``kernel_q``
(in, out) becomes ``cls*.{0,3}.weight_q`` (out, in) and ``kernel_scale``
``weight_scale``, beside the float ``bias``. A model with the MCB head
(``use_mcb``) has ``cls_mcb`` in place of ``cls``, and its two frozen
sketches come from the JAX ``constants`` collection as ``mcb.sketch1`` and
``mcb.sketch2``. :func:`table_opt_from_jax` carries the sparse table's Adam
state (``parallel/sparse_table.py``).

This module reads numpy arrays only; it imports no JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

GLOVE_SLOTS = (
    "att_vis_grid.syb_emb.weight",
    "att_syb.syb_emb.weight",
    "MIL_NCE.syb_emb.weight",
)


def _branch_entries(src: str, num_blocks: int) -> List[Tuple[str, Tuple[str, ...], bool]]:
    out = []

    def add(tname, path, transpose=False):
        out.append((f"{src}.{tname}", (src, *path), transpose))

    add("syb_emb.weight", ["syb_emb", "table"])
    add("syb_mlp.0.weight", ["body", "syb_mlp", "kernel"], True)
    add("syb_mlp.0.bias", ["body", "syb_mlp", "bias"])
    add("syb_mlp2.weight", ["body", "syb_mlp2", "kernel"], True)
    add("syb_mlp2.bias", ["body", "syb_mlp2", "bias"])
    # the vis branch's PE sits in a Sequential with its dropout, the syb branch's is bare
    pe = "syb_positional_encoding.0" if src == "att_vis_grid" else "syb_positional_encoding"
    add(f"{pe}.lookup_table", ["body", "syb_positional_encoding", "lookup_table"])
    add("dec_emb.lookup_table", ["body", "dec_emb", "lookup_table"])
    add("dec_positional_encoding.lookup_table", ["body", "dec_positional_encoding", "lookup_table"])

    for i in range(num_blocks):
        for mod, parent in (
            (f"enc_self_attention_{i}", ["body", f"block_{i}"]),
            (f"dec_self_attention_{i}", ["body"]),
            (f"dec_vanilla_attention_{i}", ["body"]),
        ):
            for ref, here in (("Q_proj", "q_proj"), ("K_proj", "k_proj"), ("V_proj", "v_proj")):
                add(f"{mod}.{ref}.0.weight", parent + [mod, here, "kernel"], True)
                add(f"{mod}.{ref}.0.bias", parent + [mod, here, "bias"])
            add(f"{mod}.normalization.gamma", parent + [mod, "ln", "gamma"])
            add(f"{mod}.normalization.beta", parent + [mod, "ln", "beta"])
        for mod, parent in (
            (f"enc_feed_forward_{i}", ["body", f"block_{i}"]),
            (f"dec_feed_forward_{i}", ["body"]),
        ):
            add(f"{mod}.conv1.0.weight", parent + [mod, "fc1", "kernel"], True)
            add(f"{mod}.conv1.0.bias", parent + [mod, "fc1", "bias"])
            add(f"{mod}.conv2.weight", parent + [mod, "fc2", "kernel"], True)
            add(f"{mod}.conv2.bias", parent + [mod, "fc2", "bias"])
            add(f"{mod}.normalization.gamma", parent + [mod, "ln", "gamma"])
            add(f"{mod}.normalization.beta", parent + [mod, "ln", "beta"])
    return out


def name_map(num_blocks: int) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """(torch name, JAX param path, transpose) of the model. ``MIL_NCE.R``
    exists only with ``only_obj=False``, ``cls`` only without the MCB head
    and ``cls_mcb`` only with it; a tree without one gives a state_dict
    without it."""
    entries = _branch_entries("att_vis_grid", num_blocks) + _branch_entries("att_syb", num_blocks)
    entries.append(("MIL_NCE.syb_emb.weight", ("mil_nce", "syb_emb", "table"), False))
    for mod in ("marco_mlp", "syb_mlp", "vis_mlp", "ipt_mlp"):
        entries.append((f"MIL_NCE.{mod}.0.weight", ("mil_nce", mod, "kernel"), True))
        entries.append((f"MIL_NCE.{mod}.0.bias", ("mil_nce", mod, "bias"), False))
    entries.append(("MIL_NCE.R", ("mil_nce", "R"), False))
    for head in ("cls", "cls_vis", "cls_syb", "cls_mcb"):
        entries.append((f"{head}.0.weight", (f"{head}_hidden", "kernel"), True))
        entries.append((f"{head}.0.bias", (f"{head}_hidden", "bias"), False))
        entries.append((f"{head}.3.weight", (f"{head}_out", "kernel"), True))
        entries.append((f"{head}.3.bias", (f"{head}_out", "bias"), False))
    return entries


def _get(tree: dict, path) -> Optional[np.ndarray]:
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return np.asarray(node)


def _int8_entries(num_blocks: int) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """(torch name, JAX path, transpose) of an ``int8_serving`` tree's
    quantized leaves: each float ``.weight`` entry of a GloVe table or a
    head Linear gives a ``weight_q`` and a ``weight_scale``."""
    out = []
    for tname, path, transpose in name_map(num_blocks):
        if path[-1] == "table":
            out.append((tname + "_q", path[:-1] + ("table_q",), False))
            out.append((tname + "_scale", path[:-1] + ("table_scale",), False))
        elif tname.startswith("cls") and tname.endswith(".weight"):
            out.append((tname + "_q", path[:-1] + ("kernel_q",), True))
            out.append((tname + "_scale", path[:-1] + ("kernel_scale",), False))
    return out


def state_dict_from_jax(params: Dict, num_blocks: int,
                        constants: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The port's state_dict (CPU tensors: float32, int8 where the tree holds
    int8) from a JAX ``params`` tree.

    ``params`` is ``variables["params"]`` of the TPU package's ``AttModelX3``,
    obj-only or obj+rel, float or ``int8_serving``, with the concat head or
    the MCB head; for the MCB head ``constants`` is
    ``variables["constants"]``, whose ``sketch1`` and ``sketch2`` become
    ``mcb.sketch1`` and ``mcb.sketch2``.
    """
    out: Dict[str, np.ndarray] = {}
    for tname, path, transpose in name_map(num_blocks) + _int8_entries(num_blocks):
        val = _get(params, path)
        if val is None:
            continue
        out[tname] = val.T if transpose else val
    for leaf, suffix in (("table", ""), ("table_q", "_q"), ("table_scale", "_scale")):
        shared = _get(params, ("glove", leaf))
        if shared is not None:
            for slot in GLOVE_SLOTS:
                out[slot + suffix] = shared
    for name in ("sketch1", "sketch2"):
        sketch = _get(constants or {}, (name,))
        if sketch is not None:
            out[f"mcb.{name}"] = sketch
    # np.array copies: JAX hands out read-only buffers, torch wants writable ones
    return {k: torch.from_numpy(np.array(v, dtype=np.int8 if v.dtype == np.int8 else np.float32,
                                         order="C"))
            for k, v in out.items()}


def table_opt_from_jax(topt) -> Dict[str, torch.Tensor]:
    """The sparse table's Adam state (``count``, ``mu``, ``nu``; the TPU
    package's ``TableOpt``, numpy leaves) as CPU tensors, the moments in
    their dtype (bfloat16 through float32, which holds it exactly)."""
    def moments(a):
        a = np.asarray(a)
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)

    return {"count": torch.tensor(int(np.asarray(topt.count)), dtype=torch.int32),
            "mu": moments(topt.mu), "nu": moments(topt.nu)}
