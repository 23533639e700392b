"""Checkpoint save and resume in the port's own format (counterpart of the
TPU package's ``utils/checkpoint.py``, which writes orbax trees).

One file per epoch, ``<ckpt_dir>/epoch_<N>.pt``, written with ``torch.save``
under a temporary name and renamed into place, so a reader never sees half a
file. It holds:

* ``params``: the model's ``state_dict`` on the CPU, under the reference
  names the port's modules carry. A tensor that several names share (the
  one GloVe table of ``share_glove`` fills the three
  ``models/convert.py:GLOVE_SLOTS``) is saved once, and ``tied`` maps each
  other name to the one saved; loading ties them again;
* ``optimizer``: the optimizer's ``state_dict`` (Adam's moments and step
  counts, the warmup schedule's entries);
* ``table_opt`` (with the sparse table only): the table's Adam ``count``,
  ``mu`` and ``nu``, the moments in their own dtype;
* ``generator`` (when the trainer passes one): the dropout generator's
  state, so a resumed run draws the masks an uninterrupted one would; in a
  data-parallel run also ``generators``, every rank's, gathered to rank 0;
* ``step`` and ``epoch``.

In a data-parallel run (``mesh`` of several ranks) rank 0 writes the file
and every rank waits for it at a barrier; every rank reads it on resume
and takes its own generator's state back. A file is always in the
one-process layout: on the model axis the shards of the split parameters
and of their Adam moments are gathered whole before rank 0 writes them,
and a resumed run reads them whole and slices its shards again
(``parallel/train_step.py:shard_state``), so a ``--model_parallel 2``
file serves in one process and the other way round.

The reference's ``model_{epoch}.pth`` goes in through
``models/torch_import.py`` and out through ``models/torch_export.py``. An
orbax directory written by the TPU package does not load here (orbax
imports JAX): that package's ``models/torch_export.py:save_pth`` writes it
as a ``.pth``, which ``models/torch_import.py`` reads.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

import torch.distributed as dist

from structured_alignment_vqa_tpu_torch.parallel.mesh import Mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    full_state_dict,
    gather_rows,
    split_of,
    unshard,
)
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch}.pt")


def saved_epochs(ckpt_dir: str) -> List[int]:
    """The epochs saved under ``ckpt_dir``, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    epochs = saved_epochs(ckpt_dir)
    return epochs[-1] if epochs else None


def _untied_params(state_dict: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    params: Dict[str, torch.Tensor] = {}
    tied: Dict[str, str] = {}
    first: Dict[tuple, str] = {}
    for name, t in state_dict.items():
        key = (t.device, t.data_ptr(), t.dtype, tuple(t.shape), tuple(t.stride()))
        if key in first:
            tied[name] = first[key]
        else:
            first[key] = name
            params[name] = t.detach().to("cpu", copy=True)
    return params, tied


def _full_optimizer_state(state: TrainState) -> dict:
    """The optimizer's state_dict with the moments of split parameters
    gathered whole (the live state is left as it is)."""
    sd = state.optimizer.state_dict()
    splits = split_of(state.model)
    if not splits:
        return sd
    names = {id(p): n for n, p in state.model.named_parameters()}
    order = [p for group in state.optimizer.param_groups for p in group["params"]]
    out = dict(sd, state=dict(sd["state"]))
    for i, p in enumerate(order):
        split = splits.get(names.get(id(p)))
        if split is None or i not in sd["state"]:
            continue
        out["state"][i] = {k: unshard(t, split, split.dim)
                           if torch.is_tensor(t) and t.shape == p.shape and t.dim() else t
                           for k, t in sd["state"][i].items()}
    return out


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    max_to_keep: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None) -> str:
    """Save params, optimizer state (the sparse table's too), step and epoch
    as epoch ``epoch``, and ``generator``'s state when given; with
    ``max_to_keep``, delete the oldest epochs beyond it. Returns the path.
    With a ``mesh`` of several ranks every rank calls this: rank 0 writes
    the file with every rank's generator state, the others wait for it."""
    path = checkpoint_path(ckpt_dir, epoch)
    generators = None
    # whole tensors (every rank of a model row takes part in the gathers)
    whole = full_state_dict(state.model)
    optimizer = _full_optimizer_state(state)
    if mesh is not None and mesh.distributed:
        if generator is not None:
            (every,), sizes = gather_rows([generator.get_state()], mesh, dtype=torch.uint8)
            # clones: a view's storage offset would be saved with it, and
            # Generator.set_state reads a state from the start of its storage
            generators = [g.clone() for g in every.split([row[0] for row in sizes])]
        if mesh.rank != 0:
            dist.barrier(group=mesh.cpu_group)
            return path
    os.makedirs(ckpt_dir, exist_ok=True)
    params, tied = _untied_params(whole)
    payload = {"params": params, "tied": tied, "optimizer": optimizer,
               "step": int(state.step), "epoch": int(epoch)}
    if state.table_opt is not None:
        topt = state.table_opt
        payload["table_opt"] = {"count": topt.count.cpu(), "mu": topt.mu.cpu(),
                                "nu": topt.nu.cpu()}
    if generator is not None:
        payload["generator"] = generator.get_state()
    if generators is not None:
        payload["generators"] = generators
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if max_to_keep:
        for old in saved_epochs(ckpt_dir)[:-max_to_keep]:
            os.unlink(checkpoint_path(ckpt_dir, old))
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.cpu_group)
    return path


def _load(ckpt_dir: str, epoch: Optional[int]) -> Tuple[dict, int]:
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    payload = torch.load(checkpoint_path(ckpt_dir, epoch), map_location="cpu",
                         weights_only=True)
    return payload, epoch


def _load_params(model: torch.nn.Module, payload: dict) -> None:
    params = dict(payload["params"])
    for alias, source in payload["tied"].items():
        params[alias] = params[source]
    model.load_state_dict(params)


def restore_checkpoint(ckpt_dir: str, state: TrainState, epoch: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       mesh: Optional[Mesh] = None) -> Tuple[TrainState, int]:
    """Restore params, optimizer state (the sparse table's too) and step
    into ``state`` (in place), and ``generator``'s state when given and
    saved; returns ``(state, epoch)``. ``epoch=None`` takes the latest.
    With a ``mesh`` of several ranks each rank takes its own generator's
    state (or its data row's: a checkpoint of one generator a data row); a
    checkpoint saved by another number of ranks raises."""
    payload, epoch = _load(ckpt_dir, epoch)
    if (state.table_opt is None) != ("table_opt" not in payload):
        raise ValueError(f"{checkpoint_path(ckpt_dir, epoch)} and the state disagree on "
                         "the sparse table (--sparse_table)")
    _load_params(state.model, payload)
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.table_opt is not None:
        for name, saved in payload["table_opt"].items():
            mine = getattr(state.table_opt, name)
            if saved.dtype != mine.dtype or saved.shape != mine.shape:
                raise ValueError(f"the saved table moments are {saved.dtype} "
                                 f"{tuple(saved.shape)}, the state's {mine.dtype} "
                                 f"{tuple(mine.shape)} (--table_moments_bf16?)")
            mine.copy_(saved)
    if generator is not None and mesh is not None and mesh.distributed:
        saved = payload.get("generators", [payload["generator"]] if "generator" in payload
                            else [])
        # one a rank, or one a data row (the ranks of a model row draw alike)
        if len(saved) == mesh.world:
            generator.set_state(saved[mesh.rank].clone())
        elif len(saved) == mesh.data:
            generator.set_state(saved[mesh.data_index].clone())
        else:
            raise ValueError(f"{checkpoint_path(ckpt_dir, epoch)} holds the dropout generators "
                             f"of {len(saved)} rank(s); this run has {mesh.world}")
    elif generator is not None and "generator" in payload:
        generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, int(epoch)


def load_params_for_eval(ckpt_dir: str, model: torch.nn.Module,
                         epoch: Optional[int] = None) -> int:
    """The eval drivers' loader: the params into ``model`` (in place);
    returns the saved step. Eval never reads the optimizer's state, so none
    is needed, as in the TPU package's."""
    payload, _ = _load(ckpt_dir, epoch)
    _load_params(model, payload)
    return int(payload["step"])
