"""The port's model -> a reference ``.pth`` state dict (counterpart of the
TPU package's ``models/torch_export.py``; the inverse of
``models/torch_import.py``).

The reference's eval script strips ``module.`` and loads *strictly*
(`models/eval_itp_grid_ddp_tar_gt.py:108-116`). :func:`export_state_dict`
writes the reference's canonical key set: the visual branch's positional
encoding as ``...syb_positional_encoding.0.lookup_table``, the symbolic
branch's bare; under ``share_glove`` the one table in all three
``convert.GLOVE_SLOTS``; with the MCB head its two sketches. Pass
``template`` (a fresh reference ``model.state_dict()``) for a dict a strict
load takes: only the template's keys, shapes checked, the parameters the
reference's forward never reads kept at the template's values. Tensors are
float32 on the CPU, and names that share a tensor in the model share one
storage, so ``torch.save`` writes the shared GloVe table once. An
``int8_serving`` model raises: the TPU package exports float parameters
only. A model split over the model axis exports whole tensors (every rank
of its model row calls :func:`export_state_dict`: the shards are gathered,
``parallel/sharding.py:full_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from structured_alignment_vqa_tpu_torch.models.convert import GLOVE_SLOTS
from structured_alignment_vqa_tpu_torch.models.torch_import import (
    SKETCHES,
    reference_names,
    strip_ddp,
)
from structured_alignment_vqa_tpu_torch.parallel.sharding import full_state_dict


def export_state_dict(model: torch.nn.Module, template: Optional[Dict] = None,
                      ddp_prefix: bool = True) -> Dict[str, torch.Tensor]:
    """``{name: float32 CPU tensor}`` of ``model`` under the reference's
    names, ``module.``-prefixed with ``ddp_prefix`` (the reference's DDP
    checkpoints, `main_itp_ddp_tar_super_node.py:427`), in the TPU
    package's key order."""
    cfg = model.cfg
    if cfg.int8_serving:
        raise ValueError("an int8_serving model has no float parameters to export; "
                         "export the float model it was quantized from")
    own = full_state_dict(model)
    tmpl = strip_ddp(template) if template is not None else None

    picked: Dict[str, torch.Tensor] = {}
    for ref, mine in reference_names(cfg.num_blocks, cfg.only_obj, cfg.use_mcb):
        if mine not in own or (cfg.share_glove and mine in GLOVE_SLOTS):
            continue
        if (ref not in tmpl) if tmpl is not None else ref != mine:
            continue
        picked[ref] = own[mine]
    extra = (GLOVE_SLOTS if cfg.share_glove else ()) + (SKETCHES if cfg.use_mcb else ())
    for name in extra:
        if tmpl is None or name in tmpl:
            picked[name] = own[name]

    copies: Dict[tuple, torch.Tensor] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, t in picked.items():
        key = (t.device, t.data_ptr(), tuple(t.shape), tuple(t.stride()))
        if key not in copies:
            copies[key] = t.detach().to("cpu", torch.float32, copy=True).contiguous()
        out[name] = copies[key]
    if tmpl is not None:
        for name, v in tmpl.items():
            if name in out:
                if tuple(out[name].shape) != tuple(v.shape):
                    raise ValueError(f"shape mismatch at {name}: exporting "
                                     f"{tuple(out[name].shape)}, reference expects "
                                     f"{tuple(v.shape)}")
            else:
                out[name] = torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
    prefix = "module." if ddp_prefix else ""
    return {prefix + k: v for k, v in out.items()}


def save_pth(path: str, model: torch.nn.Module, **kw) -> None:
    """``torch.save`` :func:`export_state_dict`, the reference's
    ``model_{epoch}.pth``."""
    torch.save(export_state_dict(model, **kw), path)
