"""Ablation-model eval CLI (counterpart of the TPU package's
``train/evaluate_variants.py``; reference ``eval_itp_grid_ddp_tar_gt.py``).

* model_v 1 -> 'x', 2 -> 'x2' (``--with_dec`` -> 'x2_dec'), plus any name
  from ``models/variants.VARIANTS`` via ``--variant``;
* loader: any preset of ``data/node_graph_dataset.config_for_variant``
  (default 'itp_gt', the reference eval's loader);
* single-logits eval: smoothed CE + in-vocab accuracy over
  ``sample_valid``.

Usage:
    python -m structured_alignment_vqa_tpu_torch.train.evaluate_variants \
        --data_dir_azure /data/gqa --model_v 2 --with_dec --split val

The model is ``build_variant`` in float32, in eval mode (dropout 0), on the
CUDA card (raising without one) unless ``--platform cpu``. Every batch is
built first, the last short one padded with ``None`` samples, as in the
TPU package; the log then says the loader's samples/s and the eval's
pairs/s apart, so that a reader sees which one sets the rate. The
per-batch sums stay on the device and are read once every ``--log_steps``
batches and at the end, then added in batch order, so the loss is the
one-read-per-batch loop's.

Call signatures follow the TPU package's CLI (its ``eval_batches``):
the dec family gets (vis, vis_mask2d, q, q_mask2d, q_graph, node,
node_mask2d, node_graph), the MIL family 1-D masks (x6 also
``idx_of_obj``, emitted by ``--loader itp_bbox_q``), everything else the
max-pool family's (vis, q, q_mask, q_graph, node, node_mask, node_graph).
``x2_fusion_dec_relatt``, ``x2_fusion_dec_mil(2)``, ``x3_ori`` and
``x4_dec`` (which falls to the max-pool form, one argument short) take
other inputs than those, so this CLI fails on them with a TypeError
exactly as the TPU package's does; their forwards are reached from
``models/variants.py``.

``--weight_dir`` reads a checkpoint written by the port's
``utils/checkpoint.py`` (``train/evaluate.py`` reads the same). The TPU
package's orbax directories need JAX: pass them through the TPU package's
side first.
"""

from __future__ import annotations

import argparse
import datetime
import time

import torch
import torch.nn.functional as F

from structured_alignment_vqa_tpu_torch.data.node_graph_dataset import (
    NodeGraphDataset,
    collate_node_graph,
    config_for_variant,
)
from structured_alignment_vqa_tpu_torch.device import resolve_device
from structured_alignment_vqa_tpu_torch.models.config import ModelConfig
from structured_alignment_vqa_tpu_torch.models.variants import build_variant
from structured_alignment_vqa_tpu_torch.ops.layers import label_smoothing
from structured_alignment_vqa_tpu_torch.utils.checkpoint import load_params_for_eval
from structured_alignment_vqa_tpu_torch.utils.logging import setup_logging
from structured_alignment_vqa_tpu_torch.utils.metrics import AverageMeter

# model_v 3 is absent, as in the TPU package: the reference eval script's
# v3 path calls the 14-argument AttModel_x3 with 9 arguments
MODEL_V_TO_VARIANT = {1: "x", 2: "x2"}

# variants taking the (vis, vis_mask2d, q, q_mask2d, ...) block-diag signature
DEC_FAMILY = {"x2_dec", "x2_dec_ori", "x2_mlp_dec", "x2_syb_dec",
              "x2_fusion_dec", "x2_fusion_dec_relatt"}
# variants taking 1-D masks and returning (logits, att_weights); x6 also
# takes idx_of_obj
MIL_FAMILY = {"x5_dec_mil", "x6_dec_mil", "x7_dec_mil"}

_INT_FIELDS = ("q_ipt", "node_ipt", "idx_of_obj", "answer")


def _square(mask_1d: torch.Tensor) -> torch.Tensor:
    """(B, L) validity -> (B, L, L) top-left square (the x2_dec batch format)."""
    return mask_1d[:, :, None] * mask_1d[:, None, :]


def family_of(variant: str) -> str:
    return "dec" if variant in DEC_FAMILY else ("mil" if variant in MIL_FAMILY else "maxpool")


def batch_tensors(batch: dict, device) -> dict:
    """A ``collate_node_graph`` batch on ``device``: ids int64, the rest float32."""
    return {k: torch.as_tensor(v, dtype=torch.int64 if k in _INT_FIELDS else torch.float32,
                               device=device) for k, v in batch.items()}


def variant_logits(model, family: str, t: dict) -> torch.Tensor:
    """The logits of ``model`` on batch ``t`` (tensors of :func:`batch_tensors`),
    called as the TPU package's CLI calls each family."""
    vis, q, qm, qg = t["vis_fea"], t["q_ipt"], t["q_mask"], t["q_graph"]
    node, nm, ng = t["node_ipt"], t["node_mask"], t["node_graph"]
    ones = torch.ones(vis.shape[:2], dtype=torch.float32, device=vis.device)
    if family == "dec":
        logits = model(vis, _square(ones), q, _square(qm), qg, node, _square(nm), ng)
    elif family == "mil":
        args = (vis, ones, q, qm, qg, node, nm, ng)
        if "x6" in type(model).__name__.lower():
            args = args + (t["idx_of_obj"],)
        logits = model(*args)
    else:
        logits = model(vis, q, qm, qg, node, nm, ng)
    return logits[0] if isinstance(logits, tuple) else logits


def batch_sums(model, family: str, t: dict) -> torch.Tensor:
    """(sum of the smoothed CE over valid samples, in-vocab correct, valid
    count) of one batch, a float32 (3,) tensor on the batch's device."""
    return logit_sums(variant_logits(model, family, t), t)


def logit_sums(logits: torch.Tensor, t: dict) -> torch.Tensor:
    """:func:`batch_sums` from the batch's logits."""
    log_sm = F.log_softmax(logits.float(), dim=-1)
    answer = t["answer"]
    one_hot = label_smoothing(F.one_hot(answer, logits.shape[-1]).float())
    per = -(one_hot * log_sm).sum(dim=-1)
    v = t["sample_valid"]
    pred = log_sm.argmax(dim=-1)
    in_vocab = (answer != 0).float() * v
    return torch.stack([(per * v).sum(), ((pred == answer).float() * in_vocab).sum(), v.sum()])


@torch.no_grad()
def eval_batches(model, batches, logger, log_steps: int = 100, family: str = "maxpool",
                 device=None):
    """Single-logits eval loop (``eval_itp_grid_ddp_tar_gt.py:37-79``):
    ``(average loss, correct, count)`` over ``batches`` (dicts of numpy
    arrays from :func:`collate_node_graph`).

    Each batch's sums stay on the device; they are read to the host once
    every ``log_steps`` batches and at the end, and then added in batch
    order exactly as a loop reading every batch would add them.
    """
    device = resolve_device(device)
    model.eval()
    loss_meter = AverageMeter()
    n_correct = 0.0
    n_total = 0.0
    pending = []

    def drain():
        nonlocal n_correct, n_total
        if not pending:
            return
        for loss_sum, corr, n in torch.stack(pending).cpu().tolist():
            if n > 0:
                loss_meter.update(loss_sum / n, int(n))
            n_correct += corr
            n_total += n
        pending.clear()

    for i, b in enumerate(batches):
        pending.append(batch_sums(model, family, batch_tensors(b, device)))
        if (i + 1) % log_steps == 0:
            drain()
            logger.info("Step [%d], Avg Loss: %s", i + 1, loss_meter.avg)
    drain()
    return loss_meter.avg, n_correct, n_total


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="SA-VQA variant eval CLI")
    ap.add_argument("--data_dir_azure", required=True)
    ap.add_argument("--output_dir", default="./tmp")
    ap.add_argument("--model_v", type=int, default=2)
    ap.add_argument("--variant", type=str, default=None,
                    help="explicit variant name, overrides --model_v")
    ap.add_argument("--with_dec", action="store_true")
    ap.add_argument("--loader", type=str, default="itp_gt")
    ap.add_argument("--split", type=str, default="val")
    ap.add_argument("--q_tar_fn", default="val.tar")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--maxlen", type=int, default=300)
    ap.add_argument("--maxlen_q", type=int, default=50)
    ap.add_argument("--maxlen_v", type=int, default=49)
    ap.add_argument("--hidden_size", type=int, default=512)
    ap.add_argument("--num_blocks", type=int, default=6)
    ap.add_argument("--num_heads", type=int, default=8)
    ap.add_argument("--min_cnt", type=int, default=10)
    ap.add_argument("--vocab_size", type=int, default=407000)
    ap.add_argument("--glove_dim", type=int, default=300)
    ap.add_argument("--weight_dir", type=str, default=None,
                    help="checkpoint directory written by the port (utils/checkpoint.py); "
                         "an orbax directory of the TPU package must pass through that "
                         "package first")
    ap.add_argument("--weight_epoch", type=int, default=None)
    ap.add_argument("--log_steps", type=int, default=100)
    ap.add_argument("--platform", type=str, default=None,
                    help="'cpu' runs on the CPU; anything else, or none, on the CUDA card")
    return ap


def variant_from_args(args) -> str:
    if args.variant is not None:
        return args.variant
    variant = MODEL_V_TO_VARIANT[args.model_v]
    if args.model_v == 2 and args.with_dec:
        variant = "x2_dec"
    return variant


def model_config(args, ds: NodeGraphDataset) -> ModelConfig:
    return ModelConfig(
        num_classes=len(ds.ans_w2id) + 1,
        num_relations=len(ds.builder.gt_relation_clean) + 1,
        vocab_size=args.vocab_size, glove_dim=args.glove_dim,
        hidden_size=args.hidden_size, num_blocks=args.num_blocks,
        num_heads=args.num_heads, dropout_rate=0.0,
        maxlen=args.maxlen, maxlen_q=args.maxlen_q, maxlen_v=args.maxlen_v,
        stage1_blocks=min(2, args.num_blocks), stage2_blocks=min(4, args.num_blocks),
    )


def load_batches(ds: NodeGraphDataset, args) -> list:
    """Every sample of ``ds`` collated in order into batches of
    ``--batch_size``, the last padded with ``None`` samples."""
    lv, ls, lq = args.maxlen_v, args.maxlen - args.maxlen_q, args.maxlen_q
    batches, pool = [], []
    for i in range(len(ds)):
        pool.append(ds.sample(i))
        if len(pool) == args.batch_size:
            batches.append(collate_node_graph(pool, lv, ls, lq))
            pool = []
    if pool:
        batches.append(collate_node_graph(pool + [None] * (args.batch_size - len(pool)),
                                          lv, ls, lq))
    return batches


def main(argv=None):
    """Returns ``(loss, accuracy)``."""
    args = build_parser().parse_args(argv)
    variant = variant_from_args(args)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    logger = setup_logging(args.output_dir, 0)
    dcfg = config_for_variant(
        args.loader, args.data_dir_azure, q_tar=args.q_tar_fn,
        maxlen=args.maxlen, min_cnt=args.min_cnt,
    )
    ds = NodeGraphDataset(args.split, dcfg)
    torch.manual_seed(0)
    model = build_variant(variant, model_config(args, ds), device=device)
    if args.weight_dir:
        load_params_for_eval(args.weight_dir, model, args.weight_epoch)

    t0 = time.perf_counter()
    batches = load_batches(ds, args)
    load_s = time.perf_counter() - t0
    logger.info("loader: %d samples in %.3f s (%.1f samples/s, cold)", len(ds), load_s,
                len(ds) / max(load_s, 1e-9))

    t0 = time.perf_counter()
    loss, corr, n = eval_batches(model, batches, logger, args.log_steps,
                                 family=family_of(variant), device=device)
    eval_s = time.perf_counter() - t0
    logger.info("eval: %d batches of %d, %d valid pairs in %.3f s (%.1f pairs/s, "
                "%.2f ms a batch)", len(batches), args.batch_size, n, eval_s,
                n / max(eval_s, 1e-9), 1e3 * eval_s / max(len(batches), 1))
    acc = corr / max(n, 1)
    logger.info(
        "Time %s, Eval[%s/%s] Loss: %s, accuracy: %s/%s = %s",
        datetime.datetime.now(), variant, args.split, loss, corr, n, acc,
    )
    return loss, acc


if __name__ == "__main__":
    main()
