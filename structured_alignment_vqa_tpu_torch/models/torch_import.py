"""Reference-checkpoint import: a ``model_{epoch}.pth`` state dict into the
port's AttModelX3 (counterpart of the TPU package's
``models/torch_import.py``).

The reference saves ``model.state_dict()`` each epoch
(`main_itp_ddp_tar_super_node.py:427-428`), with DDP's ``module.`` prefix.
The port's modules carry the reference's names (``models/convert.py``), so
no tensor is renamed or transposed. :func:`import_torch_state_dict`:

* strips ``module.``;
* takes either spelling of a positional-encoding key (``...
  syb_positional_encoding.0.lookup_table`` or ``...lookup_table``, in both
  branches), the later in the TPU package's name map winning where a dict
  holds both;
* fills ``mcb.sketch1``/``mcb.sketch2`` into the MCB head's buffers;
* under ``share_glove`` fills the one table from the first of
  ``convert.GLOVE_SLOTS`` the dict holds; a later slot that holds another
  table is left unused, since the model has room for one;
* skips the reference's parameters that its forward never reads
  (:data:`DEAD_PREFIXES`, the TPU package's list; ``MIL_NCE.R`` too when
  ``only_obj``, and ``mcb.``/``cls_mcb.`` without the MCB head);
* takes ``only_obj`` and the MCB head from the model's configuration,
  which the TPU package's import takes as arguments (a flax variables
  dict does not carry its configuration);
* raises ``ValueError`` naming a key whose shape is not the model's;
* returns the keys it used nowhere and did not skip, as the TPU package's
  import does;
* into a model split over the model axis, copies each rank's shard of a
  split tensor (the file holds whole tensors).

The TPU package's orbax checkpoints do not load here, since orbax imports
JAX: its ``models/torch_export.py:save_pth`` writes them as such a ``.pth``,
which this module reads. ``models/torch_export.py`` writes the other way.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from structured_alignment_vqa_tpu_torch.models.convert import GLOVE_SLOTS, name_map
from structured_alignment_vqa_tpu_torch.parallel.sharding import split_of

# modules the reference defines but its forward never reads
# (`AttModel_x3.py:46-67,180-185,297,325-332`)
DEAD_PREFIXES = ("att_vis_grid.v_mlp", "att_vis_grid.input_proj",
                 "att_vis_grid.q_mlp", "att_vis_grid.v_positional_encoding",
                 "att_vis_grid.q_positional_encoding",
                 "att_syb.q_mlp", "att_syb.q_positional_encoding",
                 "MIL_NCE.bilinear", "MIL_NCE.rel_mlp")
SKETCHES = ("mcb.sketch1", "mcb.sketch2")
_PE = "syb_positional_encoding"


def strip_ddp(state_dict: Dict) -> Dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def reference_names(num_blocks: int, only_obj: bool, use_mcb: bool) -> List[Tuple[str, str]]:
    """(reference name, the port's name) in the order of the TPU package's
    ``name_map(num_blocks, only_obj, use_mcb)``: both spellings of each
    branch's positional encoding, ``MIL_NCE.R`` only without ``only_obj``,
    ``cls_mcb`` only with ``use_mcb``."""
    out = []
    for name, _, _ in name_map(num_blocks):
        if (name == "MIL_NCE.R" and only_obj) or (name.startswith("cls_mcb.") and not use_mcb):
            continue
        if f".{_PE}." in name:
            branch = name.split(".")[0]
            out += [(f"{branch}.{_PE}.0.lookup_table", name),
                    (f"{branch}.{_PE}.lookup_table", name)]
        else:
            out.append((name, name))
    return out


def _f32(x) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to("cpu", torch.float32)


def _check_shape(name: str, target: torch.Tensor, value: torch.Tensor, splits=None) -> None:
    """``target`` (this rank's shard, where ``splits`` splits it) must take
    the whole ``value``."""
    shape = list(target.shape)
    split = (splits or {}).get(target.data_ptr())
    if split is not None:
        shape[split.dim] *= split.n
    if tuple(shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {name}: the model holds {tuple(shape)}, "
                         f"the state dict {tuple(value.shape)}")


@torch.no_grad()
def import_torch_state_dict(state_dict: Dict, model: torch.nn.Module) -> List[str]:
    """Copy every mappable tensor of a reference ``state_dict`` (torch
    tensors or numpy arrays, ``module.``-prefixed or not) into ``model``'s
    float parameters and buffers, in place; return the unmatched keys."""
    cfg = model.cfg
    if cfg.int8_serving:
        raise ValueError("import into the float model, then quantize it "
                         "(ops/quant.py:quantize_state_dict)")
    sd = strip_ddp(state_dict)
    own = model.state_dict(keep_vars=True)
    used = set()
    # a split tensor takes this rank's shard of the whole value (by storage:
    # share_glove's slots are one tensor)
    splits = {own[name].data_ptr(): split for name, split in split_of(model).items()}

    def put(name, value):
        split = splits.get(own[name].data_ptr())
        if split is not None:
            value = split.local(value, split.dim)
        own[name].copy_(value)

    if cfg.share_glove:
        present = [slot for slot in GLOVE_SLOTS if slot in sd]
        for slot in present:
            value = _f32(sd[slot])
            _check_shape(slot, own[slot], value, splits)
            if slot == present[0]:
                first = value
                put(slot, value)
            if torch.equal(value, first):
                used.add(slot)
    pairs = (reference_names(cfg.num_blocks, cfg.only_obj, cfg.use_mcb)
             + [(name, name) for name in SKETCHES if cfg.use_mcb])
    for ref, mine in pairs:
        if ref not in sd or mine not in own or (cfg.share_glove and mine in GLOVE_SLOTS):
            continue
        value = _f32(sd[ref])
        _check_shape(ref, own[mine], value, splits)
        put(mine, value)
        used.add(ref)

    dead = (DEAD_PREFIXES + (("MIL_NCE.R",) if cfg.only_obj else ())
            + (() if cfg.use_mcb else ("mcb.", "cls_mcb.")))
    return [k for k in sd if k not in used and not k.startswith(dead)]
