"""Standalone eval driver (counterpart of the TPU package's
``train/evaluate.py``; reference ``eval_itp_grid_ddp_tar_gt.py``): load a
checkpoint written by the port, run the eval pass over a split, log and
return loss and accuracy.

Usage:
    python -m structured_alignment_vqa_tpu_torch.train.evaluate \
        --data_dir_azure /data/gqa ... --weight_dir out/checkpoints --split val

Runs on the CUDA card (and fails without one) unless ``--platform cpu``.
``--mcb`` evaluates a model with the MCB head; ``--n_pack`` configures
training and is ignored (an unpacked loader, as in the TPU package).
The eval runs on every card of the host (``train/main.py:run_ranks``):
rank r of n evaluates whole batches r, r + n, ... of the stream one
process would evaluate (``BatchLoader.strided``), and the ranks' per-batch
sums are added up in that stream's order, so that the eval over n cards
covers one card's samples and logs its numbers, as the TPU package's one
process over every local chip does. Over several hosts (``--coordinator``
with ``--num_processes`` > 1) the eval is process-sharded, as the TPU
package's: each rank evaluates its stride of the split and the sums are
global. With ``--model_parallel N`` the strides are the data rows', and
the N ranks of a row evaluate the same batches, each with its shard of the
split parameters.
"""

from __future__ import annotations

import datetime
from itertools import zip_longest

import torch
import torch.distributed as dist

from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.transfer import BatchMover, shipped
from structured_alignment_vqa_tpu_torch.models import AttModelX3
from structured_alignment_vqa_tpu_torch.parallel.mesh import single_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import shard_model
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, make_eval_step
from structured_alignment_vqa_tpu_torch.train.loop import (
    eval_metrics,
    lockstep,
    run_eval,
    summarize_eval,
)
from structured_alignment_vqa_tpu_torch.train.main import (
    build_parser,
    check_supported_flags,
    configs_from_args,
    device_from_args,
    log_flags_without_effect,
    run_ranks,
)
from structured_alignment_vqa_tpu_torch.utils.checkpoint import load_params_for_eval
from structured_alignment_vqa_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--weight_dir", type=str, required=True,
                        help="checkpoint directory written by the port")
    parser.add_argument("--weight_epoch", type=int, default=None)
    parser.add_argument("--split", type=str, default="val")
    args = parser.parse_args(argv)
    check_supported_flags(args)
    return run_ranks(args, evaluate_from_args)


def evaluate_from_args(args, mesh=None):
    """One rank's eval (``train/main.py:run_ranks``); returns (loss,
    accuracy), the same on every rank."""
    model_cfg, train_dc, val_dc, trainer_cfg = configs_from_args(args)
    mesh = mesh or single_mesh(device_from_args(args))
    device = mesh.device
    dc = val_dc if args.split == "val" else train_dc
    logger = setup_logging(trainer_cfg.output_dir, mesh.rank)
    log_flags_without_effect(args, logger)

    ds = GQASuperNodeDataset(args.split, dc)
    model = AttModelX3(model_cfg, device=device)
    step = load_params_for_eval(args.weight_dir, model, args.weight_epoch)
    if mesh.model > 1:
        shard_model(model, mesh)
    state = TrainState(model, optimizer=None, step=step)
    mover = BatchMover(device, bf16_features=model_cfg.compute_dtype == torch.bfloat16)

    if mesh.world == mesh.local_world:
        # the ranks of one host: whole batches in stride, each rank's
        # forward that of one process on its batches
        loader = BatchLoader(ds, trainer_cfg.batch_size, shuffle=False)
        eval_step = make_eval_step(model, model_cfg, with_milnce=trainer_cfg.with_milnce)
        metrics = eval_metrics(eval_step, state, (
            ship.ready() for _, ship in shipped(
                (b for _, b in loader.strided(mesh.data_index, mesh.data)), mover)))
        if mesh.distributed:
            ranks = [None] * mesh.world
            dist.all_gather_object(ranks, list(metrics), group=mesh.cpu_group)
            # batch d + k * n of the stream is data row d's k-th (one rank
            # of each model row)
            metrics = [m for batch in zip_longest(*ranks[::mesh.model]) for m in batch
                       if m is not None]
            logger.info("%s: %d batch(es) over %d ranks, each its stride of whole batches",
                        args.split, len(metrics), mesh.data)
        loss, n_correct, n = summarize_eval(metrics, logger, trainer_cfg.log_steps_val,
                                            args.split)
    else:
        local_data = max(mesh.local_world // mesh.model, 1)
        loader = BatchLoader(ds, trainer_cfg.batch_size // local_data, shuffle=False,
                             shard_idx=mesh.data_index, num_shards=mesh.data)
        eval_step = make_eval_step(model, model_cfg, with_milnce=trainer_cfg.with_milnce,
                                   mesh=mesh)
        loss, n_correct, n = run_eval(
            eval_step, state,
            lockstep((ship.ready() for _, ship in shipped(loader, mover)), mesh, logger,
                     args.split, pad=True),
            logger, trainer_cfg.log_steps_val, args.split,
        )
    acc = n_correct / max(n, 1)
    logger.info(
        "Time %s, Eval[%s] Loss: %s, accuracy: %s/%s = %s",
        datetime.datetime.now(), args.split, loss, n_correct, n, acc,
    )
    return loss, acc


if __name__ == "__main__":
    main()
