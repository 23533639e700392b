"""Batch serving: the predict step and the CLI driver, checkpoint -> answers
(counterpart of the TPU package's ``train/predict.py``).

The CLI streams a question tar through the loader, runs the ensemble-argmax
predict step on the card, and writes ``{"index", "answer_id", "answer"}``
JSONL.

Usage:
    python -m structured_alignment_vqa_tpu_torch.train.predict \
        --data_dir_azure /data/gqa ... --weight_dir out/checkpoints \
        --split val --q_tar_fn_val val.tar --out answers.jsonl

Runs on the CUDA card (and fails without one) unless ``--platform cpu``.
``--int8`` serves the checkpoint with int8 GloVe tables and heads
(``ops/quant.py``), quantized once after loading. ``--mcb`` serves a model
with the MCB head. ``--n_pack`` configures training and is ignored: the
loader here packs nothing, as the TPU package's does not.

The CLI serves on every card of the host (``train/main.py:run_ranks``, one
rank a card, the TPU package's ``fitting_mesh`` rule; one rank on the CPU).
Rank r of n serves whole batches in stride, r, r + n, ... of the stream
one process would serve, each with the rows, bucket and ``index`` base it
has there, so its answers are those of one process bitwise: the forward's
cross-sample terms (the MCB norm over the batch, the relation rewrite's
joint softmax) and K3's hidden split see the same batch. Rank 0 gathers
every rank's answers and writes them in ``index`` order; one rank writes
each answer as it is read back. ``--coordinator``
raises: the TPU package's predict loader is not sharded by host. With
``--model_parallel N`` the data rows take that stride and the N ranks of a
row serve the same batches, each with its shard of the split parameters
(``parallel/sharding.py:shard_model``): the answers are one process's.
"""

from __future__ import annotations

import json
import sys
import time
from collections import deque
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.data.dataset import BatchLoader, GQASuperNodeDataset
from structured_alignment_vqa_tpu_torch.data.transfer import BatchMover, HostFetch, shipped
from structured_alignment_vqa_tpu_torch.models import AttModelX3
from structured_alignment_vqa_tpu_torch.ops.quant import quantize_state_dict
from structured_alignment_vqa_tpu_torch.parallel.sharding import shard_model
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


def ensemble_log_softmax(model: torch.nn.Module, batch: VQABatch) -> torch.Tensor:
    """(B, num_classes) float32: the sum of the three heads' log-softmaxes,
    whose argmax is the answer."""
    lc, lv, ls, _, _ = model(batch)
    return (F.log_softmax(lv.float(), dim=-1)
            + F.log_softmax(ls.float(), dim=-1)
            + F.log_softmax(lc.float(), dim=-1))


def make_predict_step(model: torch.nn.Module) -> Callable[[VQABatch], torch.Tensor]:
    """Return ``predict(batch) -> (B,) answer ids``: the argmax of
    :func:`ensemble_log_softmax`, with the model in eval mode."""

    @torch.inference_mode()
    def predict(batch: VQABatch) -> torch.Tensor:
        model.eval()
        return torch.argmax(ensemble_log_softmax(model, batch), dim=-1)

    return predict


def serve(predict, batches, write, pipeline_depth: int = 4, warmup_batches: int = 0) -> dict:
    """Pipelined serving over ``batches`` of ``(i, host_batch,
    ShippedBatch)``, ``i`` the batch's place in its stream
    (:func:`numbered`): while the card runs batch t, the shipper thread
    copies batch t+1 and the host collates the next; each batch's answers
    start their copy to pinned host memory when the batch is queued and are
    read ``pipeline_depth`` batches later. ``write(index, row)`` is called
    for each valid sample, in order, with its row of ``predict``'s output
    read back (the answer id, for :func:`make_predict_step`). ``index``
    counts every row of the stream's batches before, padding included:
    every batch of a stream has the same rows.

    Returns ``{"n_out", "seconds", "n_timed", "seconds_all"}``: the clock of
    ``seconds`` restarts once ``warmup_batches`` batches have been drained;
    ``seconds_all`` runs from the first batch asked of the loader to the
    last answer written.
    """
    pending: deque = deque()
    start = time.perf_counter()
    stats = {"n_out": 0, "n_drained": 0, "n_at_t0": 0, "t0": start}

    def drain(fetch, valid, base):
        preds = fetch.result()        # waits for this batch's answers alone
        for j, ok in enumerate(valid):
            if ok:
                write(base + j, preds[j])
                stats["n_out"] += 1
        stats["n_drained"] += 1
        if stats["n_drained"] == warmup_batches:
            stats["t0"] = time.perf_counter()
            stats["n_at_t0"] = stats["n_out"]

    for i, host, ship in batches:
        valid = host.sample_valid
        pending.append((HostFetch(predict(ship.ready())), valid, i * len(valid)))
        if len(pending) >= max(pipeline_depth, 1):
            drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    end = time.perf_counter()
    return {"n_out": stats["n_out"], "seconds": end - stats["t0"],
            "n_timed": stats["n_out"] - stats["n_at_t0"], "seconds_all": end - start}


def numbered(pairs, mover: BatchMover):
    """``(i, host_batch, ShippedBatch)`` for the ``(i, host_batch)`` pairs
    of ``pairs`` (``BatchLoader.strided``, or ``enumerate`` of a loader),
    shipped as ``data/transfer.py:shipped`` ships them."""
    places: deque = deque()

    def hosts():
        for i, batch in pairs:
            places.append(i)
            yield batch

    for host, ship in shipped(hosts(), mover):
        yield places.popleft(), host, ship


def build_predict_parser():
    """The training CLI's parser with the predict CLI's own flags."""
    parser = build_parser()
    parser.add_argument("--weight_dir", type=str, required=True)
    parser.add_argument("--weight_epoch", type=int, default=None)
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--out", type=str, default="-", help="JSONL path or - for stdout")
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 serving: quantize the GloVe "
                             "table(s) and the classifier heads after the "
                             "checkpoint loads (ops/quant.py)")
    parser.add_argument("--batch_cache_dir", type=str, default="",
                        help="materialized-collated-batch cache "
                             "(data/batch_cache.py): the first pass persists "
                             "every batch; later passes stream mmap'd arrays "
                             "with no host compute")
    parser.add_argument("--pipeline_depth", type=int, default=4,
                        help="batches in flight before the oldest answers are "
                             "read back")
    parser.add_argument("--warmup_batches", type=int, default=0,
                        help="restart the throughput clock after this many "
                             "batches have drained (the answers themselves are "
                             "still written)")
    return parser


def main(argv=None):
    args = build_predict_parser().parse_args(argv)
    check_supported_flags(args)
    if args.coordinator:
        raise ValueError("the predict CLI serves the cards of one host; it takes no "
                         "--coordinator")
    return run_ranks(args, predict_from_args)


def predict_from_args(args, mesh=None) -> int:
    """One rank's serving (``train/main.py:run_ranks``): its stride of the
    batches; rank 0 writes every rank's answers. Returns the answers
    written on rank 0, the answers served elsewhere."""
    model_cfg, train_dc, val_dc, trainer_cfg = configs_from_args(args)
    device = device_from_args(args) if mesh is None else mesh.device
    # the data rows stride the batches; the ranks of a model row serve the
    # same whole batches, each with its shard of the split parameters
    rank, n = (0, 1) if mesh is None else (mesh.data_index, mesh.data)
    dc = val_dc if args.split == "val" else train_dc
    logger = setup_logging(trainer_cfg.output_dir, 0 if mesh is None else mesh.rank)
    log_flags_without_effect(args, logger)

    ds = GQASuperNodeDataset(args.split, dc)
    id2ans = {v: k for k, v in ds.ans_w2id.items()}
    loader = BatchLoader(
        ds, trainer_cfg.batch_size, shuffle=False, drop_last=False,
        num_threads=trainer_cfg.num_workers, num_procs=trainer_cfg.num_procs,
        cache_dir=f"{trainer_cfg.cache_dir}/{args.split}" if trainer_cfg.cache_dir else None,
        batch_cache_dir=args.batch_cache_dir or None,
    )

    model = AttModelX3(model_cfg, device=device)
    load_params_for_eval(args.weight_dir, model, args.weight_epoch)
    if args.int8:
        quantized = quantize_state_dict(model.state_dict())
        model = AttModelX3(model_cfg.replace(int8_serving=True), device=device)
        model.load_state_dict(quantized)
    if mesh is not None and mesh.model > 1:
        shard_model(model, mesh)
    predict = make_predict_step(model)
    mover = BatchMover(device, bf16_features=model_cfg.compute_dtype == torch.bfloat16)

    sink = None
    if mesh is None or mesh.rank == 0:
        sink = sys.stdout if args.out == "-" else open(args.out, "w")

    def write_line(index: int, aid: int) -> None:
        sink.write(json.dumps({"index": index, "answer_id": aid,
                               "answer": id2ans.get(aid, "<other>")}) + "\n")

    # one rank writes each answer as it is read back; several keep theirs
    # for rank 0 to write in index order
    answers: list = []
    alone = mesh is None or mesh.world == 1
    write = ((lambda index, answer: write_line(index, int(answer))) if alone
             else (lambda index, answer: answers.append((index, int(answer)))))
    try:
        stats = serve(predict, numbered(loader.strided(rank, n), mover), write,
                      args.pipeline_depth, args.warmup_batches)
        ranks = [stats]
        if not alone:
            gathered = [None] * mesh.world if mesh.rank == 0 else None
            dist.gather_object((answers, stats), gathered, dst=0, group=mesh.cpu_group)
            if mesh.rank != 0:
                return stats["n_out"]
            # one rank of each model row: its data row's answers
            gathered = gathered[::mesh.model]
            for index, aid in sorted(a for rank_answers, _ in gathered for a in rank_answers):
                write_line(index, aid)
            ranks = [st for _, st in gathered]
    finally:
        if sink not in (None, sys.stdout):
            sink.close()
    # the host's rates: every rank's answers over the slowest rank's time
    n_out = sum(st["n_out"] for st in ranks)
    n_timed = sum(st["n_timed"] for st in ranks)
    dt = max(st["seconds"] for st in ranks)
    dt_all = max(st["seconds_all"] for st in ranks)
    logger.info(
        "predicted %d answers%s in %.2fs (%.0f pairs/s); the whole stream in %.2fs "
        "(%.0f pairs/s), on %d rank(s)",
        n_out,
        f" ({n_timed} timed after {args.warmup_batches}-batch warmup)"
        if n_timed != n_out else "",
        dt, n_timed / max(dt, 1e-9), dt_all, n_out / max(dt_all, 1e-9), n,
    )
    if n > 1:
        for r, st in enumerate(ranks):
            logger.info("rank %d served %d answers in %.2fs (%.0f pairs/s)", r, st["n_out"],
                        st["seconds_all"], st["n_out"] / max(st["seconds_all"], 1e-9))
    return n_out


if __name__ == "__main__":
    main()
