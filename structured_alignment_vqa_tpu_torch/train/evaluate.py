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
With ``--coordinator`` (``train/main.py``) the eval is process-sharded, as
the TPU package's: each rank evaluates its stride of the split and the
sums are global.
"""

from __future__ import annotations

import datetime

import torch

from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.transfer import BatchMover, shipped
from structured_alignment_vqa_tpu_torch.models import AttModelX3
from structured_alignment_vqa_tpu_torch.parallel.mesh import single_mesh
from structured_alignment_vqa_tpu_torch.parallel.train_step import TrainState, make_eval_step
from structured_alignment_vqa_tpu_torch.train.loop import lockstep, run_eval
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
    """One rank's eval (``train/main.py:run_ranks``); returns (loss, accuracy)."""
    model_cfg, train_dc, val_dc, trainer_cfg = configs_from_args(args)
    mesh = mesh or single_mesh(device_from_args(args))
    device = mesh.device
    dc = val_dc if args.split == "val" else train_dc
    logger = setup_logging(trainer_cfg.output_dir, mesh.rank)
    log_flags_without_effect(args, logger)

    ds = GQASuperNodeDataset(args.split, dc)
    loader = BatchLoader(ds, trainer_cfg.batch_size // mesh.local_world, shuffle=False,
                         shard_idx=mesh.rank, num_shards=mesh.world)

    model = AttModelX3(model_cfg, device=device)
    step = load_params_for_eval(args.weight_dir, model, args.weight_epoch)
    state = TrainState(model, optimizer=None, step=step)
    eval_step = make_eval_step(model, model_cfg, with_milnce=trainer_cfg.with_milnce,
                               mesh=mesh)
    mover = BatchMover(device, bf16_features=model_cfg.compute_dtype == torch.bfloat16)

    loss, n_correct, n = run_eval(
        eval_step, state,
        lockstep((ship.ready() for _, ship in shipped(loader, mover)), mesh, logger, args.split,
                 pad=True),
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
