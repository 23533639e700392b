"""Train and eval steps (counterpart of the TPU package's
``parallel/train_step.py``), on one device or as one rank of a
data-parallel mesh.

One training step is what the reference's batch loop does
(``main_itp_ddp_tar_super_node.py:268-366``):

  forward (dropout from the caller's generator) -> ensemble smoothed CE
  (+ MIL-NCE) -> backward -> Adam update

On the card the forward launches K1 (K4 above 512 keys) and K3 and the
backward launches K2 (K5 and K6), the graph attentions' backwards; K3's
backward is autograd of its composite, as in the TPU package. With
``sparse_table`` the shared GloVe table leaves the dense Adam and takes the
lazy sparse update of ``parallel/sparse_table.py``.

Data parallel (``mesh`` of several ranks, ``parallel/mesh.py``), a step
equals the single-device step on the global batch, the ranks' rows
concatenated in rank order, as the TPU package's GSPMD step does: every
cross-sample term is global (``parallel/context.py``), each rank's loss is
its share of the global loss, the gradients are summed over the ranks in
flat buckets after the backward (``parallel/sharding.py:all_reduce_grads``;
an explicit reduction rather than a ``DistributedDataParallel`` wrapper,
which would not see the sparse table's block that ``functional_call`` puts
in place of the table), and the skip-nonfinite guard reads the summed
gradients, so every rank takes the same decision with no further
collective. :func:`shard_state` replicates rank 0's state.

A mesh with a seq axis (``parallel/mesh.py``): the ranks of one seq row
take the same rows with generators in the same state, and the encoders'
graph attention splits each sequence between them (ring or Ulysses,
``ops/attention.py``), returning the whole output to every rank of the
row and, in the backward, the whole dq, dk and dv. So the ranks of a row
hold the same gradients, and every reduction above runs over the data
column (``Mesh.data_view``): the step is the single-device step on the
global batch, as the TPU package's GSPMD step is.

A mesh with a model axis: :func:`shard_state` keeps each rank's shard of
the split parameters and of their Adam moments (the sparse table and its
moments stay whole, as in the TPU package); the ranks of a model row take
the same rows with generators in the same state, so the replicated
activations draw one dropout mask. Each split layer's collectives make its
output and its input's gradient whole (``parallel/sharding.py``), so a
replicated parameter gets the same gradient on every rank of the row, but
for a column-split layer's bias, of which each rank computes its slice:
those are summed over the model row first. The gradients are then summed
over the data column only, and the skip-nonfinite decision is agreed over
every rank, since a shard's NaN shows on its own rank alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.models.config import ModelConfig
from structured_alignment_vqa_tpu_torch.parallel.context import use_mesh
from structured_alignment_vqa_tpu_torch.parallel.mesh import Mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    all_reduce_sum,
    broadcast_,
    host_sum,
    model_partial_grads,
    shard_params,
    split_of,
)
from structured_alignment_vqa_tpu_torch.parallel.sparse_table import (
    TABLE_NAME,
    TableOpt,
    init_table_opt,
    remap_batch,
    sparse_adam_update,
)
from structured_alignment_vqa_tpu_torch.train.losses import (
    batch_metrics,
    ensemble_smoothed_ce,
    mil_nce_loss,
)


@dataclasses.dataclass
class TrainState:
    """The model (which holds the parameters), its optimizer and the number
    of steps taken. ``step`` counts skipped steps too, as the TPU package's
    ``TrainState.step`` does; the optimizer counts applied updates only.
    An eval-only state holds no optimizer (``None``). A state for the sparse
    table (:func:`create_train_state`) holds the table's Adam state in
    ``table_opt``, and its ``optimizer`` holds every parameter but the
    table."""

    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int = 0
    table_opt: Optional[TableOpt] = None


def adam(params: Iterable[nn.Parameter], lr: float = 1e-4,
         warmup_steps: int = 0) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's settings (``main:206``): betas
    (0.9, 0.999), eps 1e-8.

    ``warmup_steps`` > 0 ramps the learning rate linearly from 0 to ``lr``
    over the first ``warmup_steps`` applied updates, as
    ``optax.linear_schedule(0, lr, warmup_steps)`` does in the TPU package:
    update n (counting from 0) uses ``lr * min(n, warmup_steps) /
    warmup_steps``. The schedule lives in the parameter group (``peak_lr``,
    ``warmup_steps``, ``updates``), so it is saved with the optimizer's
    state_dict; :func:`make_train_step` applies it.
    """
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for group in opt.param_groups:
        group.update(peak_lr=lr, warmup_steps=warmup_steps, updates=0)
    return opt


def shared_table(model: nn.Module) -> nn.Parameter:
    """The one GloVe table of a ``share_glove`` model; ``ValueError`` without
    one."""
    if not model.cfg.share_glove:
        raise ValueError(
            "sparse_table requires the shared GloVe table (ModelConfig.share_glove / "
            "--share_glove): without sharing, each encoder owns its own embedding and "
            f"there is no single {TABLE_NAME} to segment the optimizer over")
    return model.get_parameter(TABLE_NAME)


def create_train_state(model: nn.Module, lr: float = 1e-4, warmup_steps: int = 0,
                       sparse_table: bool = False,
                       table_moments_dtype: torch.dtype = torch.float32) -> TrainState:
    """A fresh state: :func:`adam` over the model's parameters. With
    ``sparse_table`` Adam gets every parameter but the shared GloVe table,
    and the table's moments live in a :class:`TableOpt` in
    ``table_moments_dtype`` (the TPU package's ``create_train_state``)."""
    if not sparse_table:
        return TrainState(model, adam(model.parameters(), lr, warmup_steps))
    table = shared_table(model)
    rest = [p for p in model.parameters() if p is not table]
    return TrainState(model, adam(rest, lr, warmup_steps),
                      table_opt=init_table_opt(table.detach(), table_moments_dtype))


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Put ``state`` on the mesh: rank 0's parameters, buffers, Adam moments
    and step counts, and the sparse table's ``count``, ``mu`` and ``nu``,
    broadcast to every rank (in place; returns ``state``). The table is
    replicated, the TPU package's replicate-when-sparse rule. With a model
    axis each rank then keeps its shard of the split parameters and of
    their moments (``parallel/sharding.py:param_pspec``). A mesh without a
    group leaves the state as it is."""
    if mesh.group is None:
        return state
    if state.optimizer is not None:
        broadcast_([t for per_param in state.optimizer.state.values()
                    for t in per_param.values() if torch.is_tensor(t)], mesh)
    if state.table_opt is not None:
        topt = state.table_opt
        broadcast_([topt.count, topt.mu, topt.nu], mesh)
    whole = (TABLE_NAME,) if state.table_opt is not None else ()
    names = {id(p): n for n, p in state.model.named_parameters()}
    shard_params(state.model, mesh, keep_whole=whole)
    if state.optimizer is not None and mesh.model > 1:
        splits = split_of(state.model)
        for p, per_param in state.optimizer.state.items():
            split = splits.get(names.get(id(p)))
            if split is None:
                continue
            for key, t in per_param.items():
                if torch.is_tensor(t) and t.dim() == p.dim() and t.shape != p.shape:
                    per_param[key] = split.local(t, split.dim).contiguous()
    return state


def _global(values: Dict[str, torch.Tensor], mesh: Mesh,
            extra: float = 0.0) -> Tuple[Dict[str, torch.Tensor], float]:
    """Each metric summed over the ranks in one all-reduce (a rank's loss
    terms are its shares of the global ones, its counts its own), and the
    sum of ``extra``."""
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys]
                          + [values[keys[0]].new_tensor(extra, dtype=torch.float32)])
    summed = all_reduce_sum(stacked, mesh)
    return {k: summed[i] for i, k in enumerate(keys)}, float(summed[-1])


def _schedule_lr(optimizer: torch.optim.Optimizer) -> None:
    for group in optimizer.param_groups:
        warmup = group.get("warmup_steps", 0)
        if warmup:
            group["lr"] = group["peak_lr"] * min(group["updates"], warmup) / warmup


def _count_update(optimizer: torch.optim.Optimizer) -> None:
    for group in optimizer.param_groups:
        if "updates" in group:
            group["updates"] += 1


def _all_finite(grads) -> torch.Tensor:
    """A 0-d bool tensor: every element of every gradient is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def _objective(model: nn.Module, cfg: ModelConfig, batch: VQABatch, generator,
               with_milnce: bool, smooth_eps: float,
               table_rows: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The step's metrics; ``table_rows`` runs the model with that block in
    place of the shared GloVe table."""
    if table_rows is None:
        lc, lv, ls, mil_obj, mil_rel = model(batch, generator)
    else:
        # the three names of the table are one module's attribute: swap it
        # once. tie_weights=True would swap it once per name and, restoring
        # in the same order, leave the block in place of the table.
        lc, lv, ls, mil_obj, mil_rel = functional_call(
            model, {TABLE_NAME: table_rows}, (batch, generator), tie_weights=False)
    ce, log_sm = ensemble_smoothed_ce(lc, lv, ls, batch.answer, batch.sample_valid, smooth_eps)
    mil = mil_nce_loss(mil_obj, mil_rel, cfg.only_obj)
    loss = ce + mil if with_milnce else ce
    n_correct, n = batch_metrics(log_sm, batch.answer, batch.sample_valid)
    return {"loss": loss, "ce": ce, "mil_nce_loss": mil, "n_correct": n_correct, "n": n}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, cfg: ModelConfig,
                    with_milnce: bool = True, smooth_eps: float = 0.1,
                    skip_nonfinite: bool = True, sparse_table: bool = False,
                    mesh: Optional[Mesh] = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Return ``step(state, batch, generator) -> metrics``.

    The step puts the model in train mode; every dropout mask is drawn from
    ``generator`` (on the batch's device), so the same generator state gives
    the same step. ``metrics`` holds 0-d tensors: ``loss``, ``ce``,
    ``mil_nce_loss``, ``n_correct``, ``n`` and ``skipped``.

    ``skip_nonfinite``: a step with any non-finite gradient applies no update:
    the parameters and the Adam state (its moments and its step count) stay
    as they were, and ``skipped`` is 1, as the TPU package's ``lax.cond``
    does. Deciding that costs one read of a flag by the host per step.

    ``sparse_table``: the forward runs on the (U, D) block of the table rows
    the batch touches, a leaf that requires grad, put in place of the shared
    ``GloVeEmbed.weight`` by ``torch.func.functional_call`` (one module
    under ``MIL_NCE``, ``att_vis_grid`` and ``att_syb``, so all three see
    the block), on a batch whose ids are remapped to block positions. The
    block's gradient takes :func:`sparse_adam_update` with the optimizer's
    own schedule (``peak_lr`` and ``warmup_steps`` of its first parameter
    group, as :func:`adam` stores them); the guard covers it too, and its decision reaches the table's update as a
    device flag. The state must come from ``create_train_state(...,
    sparse_table=True)``.

    ``mesh`` (``parallel/mesh.py``): with several ranks each calls the step
    on its own rows with its own generator (seeded per rank), and the step
    is the single-device step on the global batch: the metrics are global
    (the losses of the global batch, its counts), the gradients summed over
    the ranks before the guard and the update, and the sparse table's
    dedup runs over every rank's ids. ``step.reduced_bytes`` holds the
    bytes of gradient the last step summed. With one rank, or none, the
    step is the single-device step, bit for bit.
    """
    # the ranks of a seq or model row hold the same samples and, after the
    # attention's and the split layers' collectives, the same gradients of
    # the replicated parameters: reduce over the data column alone
    dmesh = None if mesh is None else mesh.data_view()
    distributed = dmesh is not None and dmesh.distributed
    model_axis = mesh is not None and mesh.model > 1
    partial = {id(p) for p in model_partial_grads(model)} if model_axis else set()
    table = None
    if sparse_table:
        if cfg.int8_serving:
            raise ValueError("sparse_table is a training path; int8 is serving-only")
        table = shared_table(model)
    params = [p for p in model.parameters() if p.requires_grad and p is not table]

    def step(state: TrainState, batch: VQABatch,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state holds another model or optimizer than this step's")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with use_mesh(mesh):
            if table is None:
                metrics = _objective(model, cfg, batch, generator, with_milnce, smooth_eps)
                metrics["loss"].backward()
                grads = [p.grad for p in params if p.grad is not None]
            else:
                if state.table_opt is None:
                    raise ValueError("sparse_table needs a state from "
                                     "create_train_state(..., sparse_table=True)")
                rbatch, uids, valid = remap_batch(batch, cfg, dmesh)
                rows = table.detach()[uids].requires_grad_(True)
                metrics = _objective(model, cfg, rbatch, generator, with_milnce, smooth_eps,
                                     table_rows=rows)
                metrics["loss"].backward()
                grads = [p.grad for p in params if p.grad is not None] + [rows.grad]
        if partial:
            # a column-split layer's bias: each rank holds its slice's gradient
            all_reduce_grads([p.grad for p in params if id(p) in partial and p.grad is not None],
                             mesh.model_view())
        if distributed:
            metrics, n_grads = _global(metrics, dmesh, extra=len(grads))
            if n_grads != dmesh.world * len(grads):
                raise RuntimeError(f"the ranks hold {n_grads:g} gradients in all, this rank "
                                   f"{len(grads)}: their graphs differ")
            step.reduced_bytes = all_reduce_grads(grads, dmesh)
        finite = _all_finite(grads) if skip_nonfinite else None
        if finite is not None and model_axis:
            # a split parameter's NaN shows on its own rank: every rank agrees
            (bad,) = host_sum([0.0 if bool(finite) else 1.0], mesh)
            finite = torch.tensor(bad == 0.0, device=finite.device)
        if table is not None:
            group = optimizer.param_groups[0]
            sparse_adam_update(table.data, state.table_opt, rows.grad, uids, valid,
                               group.get("peak_lr", group["lr"]),
                               group.get("warmup_steps", 0), apply=finite)
        apply = True if finite is None else bool(finite)
        if apply:
            _schedule_lr(optimizer)
            optimizer.step()
            _count_update(optimizer)
        state.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["skipped"] = torch.tensor(0.0 if apply else 1.0, device=out["loss"].device)
        return out

    step.reduced_bytes = 0
    return step


def make_eval_step(model: nn.Module, cfg: ModelConfig, with_milnce: bool = True,
                   smooth_eps: float = 0.1,
                   mesh: Optional[Mesh] = None) -> Callable[[TrainState, VQABatch], Dict]:
    """Return ``eval(state, batch) -> metric sums``: ``loss_sum`` and
    ``mil_sum`` (each the batch mean times ``n``), ``n_correct`` and ``n``,
    so that a caller can add them up over batches (reference eval loop,
    ``main:42-142``). The model runs in eval mode: no dropout, no mask drawn.
    With a ``mesh`` of several ranks the sums are the global batch's, the
    same on every rank (the TPU package's psum'd metrics).
    """
    dmesh = None if mesh is None else mesh.data_view()
    distributed = dmesh is not None and dmesh.distributed

    @torch.no_grad()
    def eval_step(state: TrainState, batch: VQABatch) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("state holds another model than this eval step's")
        model.eval()
        with use_mesh(mesh):
            m = _objective(model, cfg, batch, None, with_milnce, smooth_eps)
        if distributed:
            m, _ = _global(m, dmesh)
        return {"loss_sum": m["loss"] * m["n"], "mil_sum": m["mil_nce_loss"] * m["n"],
                "n_correct": m["n_correct"], "n": m["n"]}

    return eval_step
