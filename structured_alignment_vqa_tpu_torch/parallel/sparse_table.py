"""Sparse Adam for the shared 407,000 x 300 GloVe table (counterpart of the
TPU package's ``parallel/sparse_table.py``).

A bs-128 batch looks up some thousands of distinct table rows, yet dense
Adam reads and writes all 407,000 rows, their gradient and both moments
every step. Here a step updates exactly the rows the batch touches:

1. the batch's GloVe-id fields are flattened and deduplicated at a static
   size U = the batch's total id-slot count (overflow impossible), by a
   presence bitmap and its prefix sum, with no sort and no read of U by the
   host (:func:`_dedup_ids`);
2. the step gathers those rows into a (U, 300) block and remaps the id
   fields to block positions; the model runs unchanged with the block as
   its table, so the backward scatters its gradient into U rows;
3. the moments stay dense on the device but are read and written only at
   the touched rows: gather, moment update, then masked deltas added back
   with ``index_add_``, so padding slots add exact zeros
   (:func:`sparse_adam_update`).

Semantics are ``torch.optim.SparseAdam``'s "lazy" Adam: untouched rows do not
decay their moments between touches, whereas dense Adam (the reference,
``main_itp_ddp_tar_super_node.py:206``) keeps moving them while their
momentum decays. The first update from fresh moments is dense Adam's
exactly; later ones deviate once a row goes untouched with momentum in
flight. Hence the path is opt-in (``--sparse_table``). It needs
``share_glove``: one table to segment the optimizer over.

Data parallel, the table is replicated on every rank (the TPU package's
replicate-when-sparse rule, its ``shard_state``): the ranks dedup the
union of their ids, sum the block gradient and apply the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.parallel.sharding import gather_rows

# The shared table's state-dict name (``share_glove``; the same module also
# answers to ``att_vis_grid.syb_emb.weight`` and ``att_syb.syb_emb.weight``).
TABLE_NAME = "MIL_NCE.syb_emb.weight"

# Batch fields embedded through the shared table: the two encoder bodies
# read q_ipt; MILNCEModule reads macro_ipt and the object candidates, and
# micro_pos_rel only when the relation branch runs. micro_neg_rel is never
# embedded (the reference scores negatives with the bilinear form only).
_ID_FIELDS = ("q_ipt", "macro_ipt", "micro_pos_obj", "micro_neg_obj")
_REL_ID_FIELDS = ("micro_pos_rel",)


def table_id_fields(only_obj: bool) -> tuple:
    return _ID_FIELDS + (() if only_obj else _REL_ID_FIELDS)


def _dedup_ids(flat: torch.Tensor, vocab_size: int):
    """Static-size dedup without a sort: presence bitmap + prefix-sum ranks.

    Scatter a presence bit per id into a (V,) bitmap, cumsum it, and each
    id's rank is its compacted slot: O(V) cumsum plus two O(S) gathers and
    scatters. Nothing depends on the host knowing U, so the step needs no
    synchronisation for it.

    Returns ``(uids, inverse, valid)``: ``uids`` the ascending distinct ids
    padded at the tail with ``vocab_size - 1``; ``inverse`` each input
    slot's uid slot; ``valid`` the distinct-id slots.
    """
    s = flat.shape[0]
    present = torch.zeros(vocab_size, dtype=torch.int32, device=flat.device)
    present[flat] = 1
    rank = torch.cumsum(present, 0)     # monotone in id, so uids come out sorted
    pos = rank[flat] - 1                # (S,) compacted slot of each input element
    uids = torch.full((s,), vocab_size - 1, dtype=flat.dtype, device=flat.device)
    uids[pos] = flat
    valid = torch.arange(s, device=flat.device) < rank[-1]
    return uids, pos, valid


def remap_batch(batch: VQABatch, cfg, mesh=None) -> Tuple[VQABatch, torch.Tensor, torch.Tensor]:
    """Dedup the batch's GloVe ids and remap its id fields to positions in
    the (U, D) row block ``table[uids]``.

    Returns ``(remapped_batch, uids, valid)`` as :func:`_dedup_ids` gives
    them (U = the id fields' total size); each remapped field keeps its
    dtype. With a ``mesh`` of several ranks (``parallel/mesh.py``) the
    dedup runs over the union of every rank's ids, as the TPU package's
    over its global batch: every rank gets the same ``uids`` and
    ``valid`` (U = the id slots of the global batch), so the ranks can sum
    their block gradients and take one update.
    """
    fields = table_id_fields(cfg.only_obj)
    parts = [getattr(batch, f) for f in fields]
    # clamped: the embedded fields carry PAD=400000, never -1, but an id
    # out of range would index outside the bitmap
    flat = torch.cat([p.reshape(-1) for p in parts]).long().clamp(0, cfg.vocab_size - 1)
    if mesh is None or not mesh.distributed:
        uids, inv, valid = _dedup_ids(flat, cfg.vocab_size)
    else:
        (every,), sizes = gather_rows([flat], mesh)
        uids, inv, valid = _dedup_ids(every, cfg.vocab_size)
        start = sum(row[0] for row in sizes[:mesh.rank])
        inv = inv[start:start + flat.numel()]
    out = {}
    off = 0
    for f, p in zip(fields, parts):
        n = p.numel()
        out[f] = inv[off:off + n].reshape(p.shape).to(p.dtype)
        off += n
    return dataclasses.replace(batch, **out), uids, valid


@dataclasses.dataclass
class TableOpt:
    """Adam state of the sparsely updated table: ``count`` (a 0-d int32
    tensor on the table's device) counts applied updates, as optax's
    counter does, so a skipped step leaves it alone; ``mu`` and ``nu`` are
    dense (V, D) in the moments' dtype, read and written at touched rows
    only."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def init_table_opt(table: torch.Tensor, moments_dtype=torch.float32) -> TableOpt:
    return TableOpt(
        count=torch.zeros((), dtype=torch.int32, device=table.device),
        mu=torch.zeros(table.shape, dtype=moments_dtype, device=table.device),
        nu=torch.zeros(table.shape, dtype=moments_dtype, device=table.device),
    )


@torch.no_grad()
def sparse_adam_update(table: torch.Tensor, topt: TableOpt, rows_grad: torch.Tensor,
                       uids: torch.Tensor, valid: torch.Tensor, lr: float,
                       warmup_steps: int = 0, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, apply=None) -> None:
    """One lazy-Adam update of the touched rows, in place on ``table``,
    ``topt.mu``, ``topt.nu`` and ``topt.count``.

    From fresh moments it is ``optax.adam``'s update on the touched rows
    (bias correction from the count, eps outside the sqrt); with
    ``warmup_steps`` the rate is ``optax.linear_schedule(0, lr, warmup)`` at
    the count before the update, so the first update uses rate 0 as the
    dense path does. Every write is a masked delta added with
    ``index_add_``, so padding slots add exact zeros and each row rounds as
    the TPU package's ``.at[uids].add`` does (bf16 moments too).

    ``apply``: an optional 0-d bool tensor; False zeroes every delta and
    leaves the count (the skip-nonfinite guard), with no read by the host.
    ``where`` rather than a product keeps a non-finite gradient out of the
    zeroed deltas.
    """
    do = (torch.ones((), dtype=torch.bool, device=table.device) if apply is None
          else apply.to(device=table.device, dtype=torch.bool))
    count = topt.count + do.to(topt.count.dtype)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=table.device)
    if warmup_steps:
        lr_t = lr_t * torch.clamp(topt.count.float() / warmup_steps, 0.0, 1.0)

    vm = valid[:, None]
    g = rows_grad.float() * vm
    mu_rows = topt.mu[uids].float()
    nu_rows = topt.nu[uids].float()
    new_mu = b1 * mu_rows + (1.0 - b1) * g
    new_nu = b2 * nu_rows + (1.0 - b2) * g * g
    t = count.float()
    mu_hat = new_mu / (1.0 - b1 ** t)
    nu_hat = new_nu / (1.0 - b2 ** t)
    upd = lr_t * mu_hat / (torch.sqrt(nu_hat) + eps)

    zero = torch.zeros((), dtype=torch.float32, device=table.device)

    def masked(delta):
        return torch.where(do, torch.where(vm, delta, zero), zero)

    table.index_add_(0, uids, masked(-upd).to(table.dtype))
    topt.mu.index_add_(0, uids, masked(new_mu - mu_rows).to(topt.mu.dtype))
    topt.nu.index_add_(0, uids, masked(new_nu - nu_rows).to(topt.nu.dtype))
    topt.count.copy_(count)
