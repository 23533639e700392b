"""The training loop (counterpart of the TPU package's ``train/loop.py``).

Mirrors the reference epoch structure (``main_itp_ddp_tar_super_node.py:261-428``):
a train pass per epoch, eval on the val and train loaders, metric
aggregation, a checkpoint per epoch; with the TPU package's substitutions
where the port has them: save-only .pth -> checkpoints with resume (the
dropout generator's state included), Azure ``Run.log`` -> a JSONL metric
sink, batch replay, device-resident frozen batches, the sparse table.
Batches reach the card through ``data/transfer.py`` (pinned copies on a
side stream, two batches ahead), and metrics are read back ``metric_lag``
steps late through pinned copies, so the host keeps queueing work.

Data parallel (a ``Mesh`` of several ranks, ``parallel/mesh.py``), as the
TPU package's ``train`` over several processes: each rank loads its stride
of the samples (``batch_size`` over the host's ranks a step), the state is
rank 0's (``shard_state``), the steps' metrics and the eval sums are
global, log lines and metrics come from rank 0, rank 0 writes the
checkpoints, and each rank keeps its own caches and resident batches. A
training pass ends at the first step where a rank has run out of batches;
an eval pass runs until every rank has (``lockstep``).
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch
from structured_alignment_vqa_tpu_torch.data.dataset import (
    BatchLoader,
    BatchShape,
    DataConfig,
    GQASuperNodeDataset,
    collate,
)
from structured_alignment_vqa_tpu_torch.data.transfer import BatchMover, HostFetch, shipped
from structured_alignment_vqa_tpu_torch.models import AttModelX3, ModelConfig
from structured_alignment_vqa_tpu_torch.models.att_model_x3 import GloVeEmbed
from structured_alignment_vqa_tpu_torch.parallel.mesh import Mesh, check_axes, single_mesh
from structured_alignment_vqa_tpu_torch.parallel.sharding import host_sum
from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    shard_state,
)
from structured_alignment_vqa_tpu_torch.utils.checkpoint import (
    latest_epoch,
    restore_checkpoint,
    save_checkpoint,
)
from structured_alignment_vqa_tpu_torch.utils.logging import MetricLogger, setup_logging
from structured_alignment_vqa_tpu_torch.utils.metrics import AverageMeter
from structured_alignment_vqa_tpu_torch.utils.profiling import StepTimer, start_trace, stop_trace

_METRICS = ("loss_sum", "mil_sum", "n_correct", "n")


@dataclasses.dataclass
class TrainerConfig:
    """The TPU package's ``TrainerConfig``, field for field, with its
    defaults. ``model_parallel`` must equal the mesh's model axis
    (``parallel/mesh.py``). ``n_pack > 1``
    packs the training batches (``data/packing.py``; ``pack_bucket`` picks
    their bucket, None the largest) and evaluates val through the tight
    collate."""

    output_dir: str = "./tmp"
    batch_size: int = 32
    lr: float = 1e-4
    num_epochs: int = 40
    log_steps: int = 100
    log_steps_val: int = 100
    with_milnce: bool = True
    with_smooth_labeling: bool = True  # v3 loss always smooths (`main:334-345`)
    model_parallel: int = 1
    seed: int = 0
    resume: bool = True
    checkpoint_every: int = 1
    max_checkpoints: Optional[int] = None
    num_workers: int = 8
    num_procs: int = 0  # loader worker processes (0 = thread pool)
    n_pack: int = 1
    pack_bucket: Optional[int] = None
    # cross-epoch preprocessed-sample cache root (data/sample_cache.py); each
    # split gets its own subdirectory. None = rebuild each epoch.
    cache_dir: Optional[str] = None
    # materialize epoch-0's collated train batches and replay them mmap'd in
    # a per-epoch-shuffled order (composition frozen); needs cache_dir
    batch_replay: bool = False
    # trace training steps [profile_start, profile_start + profile_steps) of
    # the first epoch run into <output_dir>/profile (utils/profiling.py)
    profile_steps: int = 0
    profile_start: int = 10
    # epochs between the val + train eval passes (the final epoch evals)
    eval_every: int = 1
    # linear LR warmup over this many updates, then the constant LR
    warmup_steps: int = 0
    # lazy sparse Adam for the shared GloVe table (parallel/sparse_table.py);
    # needs share_glove
    sparse_table: bool = False
    table_moments_bf16: bool = False
    # device memory (GB) the frozen batches of the replay and val batch
    # caches may take on the card, shipped once and reused every epoch;
    # 0 streams them every epoch
    resident_gb: float = 8.0


def run_eval(eval_step, state, loader, logger, log_steps, tag="", metric_lag: int = 4):
    """Eval pass over device batches; returns ``(avg_loss, n_correct, n)``
    (replacing `main:380-404`)."""
    return summarize_eval(eval_metrics(eval_step, state, loader, metric_lag), logger,
                          log_steps, tag)


def eval_metrics(eval_step, state, loader, metric_lag: int = 4):
    """Each batch's ``(loss_sum, mil_sum, n_correct, n)`` as floats, in
    the order of ``loader``.

    Each batch's metric sums start their copy to pinned host memory as soon
    as the batch is queued and are read ``metric_lag`` batches later, when
    that copy alone is waited for: reading the current batch's metrics
    would hold the host until the card has finished everything queued, and
    the next batch would not be queued meanwhile.
    """
    pending: deque = deque()
    for batch in loader:
        m = eval_step(state, batch)
        pending.append(HostFetch(torch.stack([m[k].float() for k in _METRICS])))
        if len(pending) > metric_lag:
            yield tuple(float(v) for v in pending.popleft().result())
    while pending:
        yield tuple(float(v) for v in pending.popleft().result())


def summarize_eval(metrics, logger, log_steps, tag=""):
    """``(avg_loss, n_correct, n)`` over the batches' metric sums
    (:func:`eval_metrics`), logging the running averages every
    ``log_steps`` batches."""
    loss_meter = AverageMeter()
    mil_meter = AverageMeter()
    n_correct = 0.0
    n_total = 0.0
    for i, (loss_sum, mil_sum, correct, n) in enumerate(metrics):
        if n > 0:
            loss_meter.update(loss_sum / n, int(n))
            mil_meter.update(mil_sum / n, int(n))
        n_correct += correct
        n_total += n
        if (i + 1) % log_steps == 0:
            logger.info(
                "Time %s, %s Step [%d], Avg Loss: %s, Avg MILNCE_loss: %s",
                datetime.datetime.now(), tag, i + 1, loss_meter.avg, mil_meter.avg,
            )
    return loss_meter.avg, n_correct, n_total


def padding_like(batch: VQABatch) -> VQABatch:
    """A batch of ``batch``'s shapes, dtypes and device that holds padding
    rows only: the rows ``collate`` writes for no sample
    (``sample_valid`` 0, no object and no relation candidate)."""
    shape = BatchShape(lv=batch.vis_fea.shape[1], ls=batch.macro_ipt.shape[1],
                       lq=batch.q_ipt.shape[1], n_rel=batch.micro_pos_rel.shape[1])
    rows = collate([None] * batch.batch_size, shape, batch.micro_pos_obj.shape[-1],
                   batch.vis_fea.shape[-1])
    like = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    return VQABatch(**{k: None if v is None else
                       torch.as_tensor(getattr(rows, k)).to(v.device, v.dtype)
                       for k, v in like.items()})


def lockstep(batches, mesh: Mesh, logger, what: str, pad: bool = False):
    """``batches`` in step with the other ranks of ``mesh``: the ranks'
    loaders can run out at different steps (each buckets its own samples),
    and a step whose collectives one rank skips would hang the others. One
    small all-reduce a step.

    A training pass (``pad=False``) ends at the first step where any rank
    has no batch: every rank drains what it has left (so that the caches
    built on the way are published) and rank 0 logs how many batches the
    ranks left over in all. An eval pass (``pad=True``) runs until every
    rank is done, a rank that has run out stepping on
    :func:`padding_like` its last batch, so that the global sums cover
    every rank's samples. With one rank, ``batches`` as they are."""
    if not mesh.distributed:
        yield from batches
        return
    it = iter(batches)
    last = None
    while True:
        batch = next(it, None)
        done, never = host_sum([batch is None, batch is None and last is None], mesh)
        if not done:
            last = batch
            yield batch
            continue
        if not pad or done == mesh.world:
            break
        if never:
            raise ValueError(f"{what}: a rank has no batch at all to pad from "
                             f"({int(never)} of {mesh.world} ranks)")
        if batch is None:
            batch = padding_like(last)
        else:
            last = batch
        yield batch
    if pad:
        return
    (left,) = host_sum([(batch is not None) + sum(1 for _ in it)], mesh)
    if left:
        logger.info("%s: the ranks stopped at the first step where one had no batch; "
                    "%d batch(es) left over on the others", what, int(left))


def new_model(model_cfg: ModelConfig, seed: int, device) -> AttModelX3:
    """The model with its initial weights drawn from ``seed`` (the global
    generators are left as they were)."""
    device = torch.device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        return AttModelX3(model_cfg, device=device)


def replay_root(cache_dir: str, seed: int, shard: str = "") -> str:
    """Where ``--batch_replay`` keeps a run's frozen batches under
    ``cache_dir``: keyed by the shuffle seed, which draws their composition
    (the batch cache's fingerprint, equal to the TPU package's, leaves the
    seed out), and by the rank's ``shard`` suffix."""
    return f"{cache_dir}/train_batches/seed{seed}{shard}"


def train(
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    trainer_cfg: TrainerConfig,
    val_data_cfg: Optional[DataConfig] = None,
    glove_table: Optional[np.ndarray] = None,
    device=None,
    mesh: Optional[Mesh] = None,
):
    """Full training run on ``device`` (``None``: the CUDA card, raising
    without one), or as one rank of ``mesh`` on its device; returns the
    final ``TrainState``.

    The TPU package draws a probe batch to build its parameters from; the
    port's modules need no sample batch, so none is drawn.
    """
    tc = trainer_cfg
    check_axes(tc.model_parallel, hidden_size=model_cfg.hidden_size,
               num_heads=model_cfg.num_heads)
    mesh = mesh or single_mesh(device)
    if mesh.model != tc.model_parallel:
        raise ValueError(f"model_parallel={tc.model_parallel}, but the mesh's model axis is "
                         f"{mesh.model}")
    device, rank, world = mesh.device, mesh.rank, mesh.world
    # the ranks of a model row take the same rows: the data ranks split the batch
    local_data = max(mesh.local_world // mesh.model, 1)
    if tc.batch_size % local_data:
        raise ValueError(f"batch_size {tc.batch_size} does not split over the host's "
                         f"{local_data} data rank(s)")
    rows = tc.batch_size // local_data
    logger = setup_logging(tc.output_dir, rank)
    metrics_out = MetricLogger(tc.output_dir, rank)
    logger.info("device: %s%s; mesh: %s over %d rank(s), %d row(s) a rank a step", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "",
                mesh.shape, world, rows)

    train_ds = GQASuperNodeDataset("train", data_cfg)
    val_ds = GQASuperNodeDataset("val", val_data_cfg or data_cfg)
    model_cfg = model_cfg.replace(topn=data_cfg.topn, only_obj=data_cfg.only_obj)
    model = new_model(model_cfg, tc.seed, device)

    # each rank its own cache roots: a root publishes one loader's batches
    shard = f"/rank{rank}of{world}" if world > 1 else ""

    def cache(split):
        return f"{tc.cache_dir}/{split}{shard}" if tc.cache_dir else None

    if tc.batch_replay and not tc.cache_dir:
        raise ValueError("batch_replay needs cache_dir for its on-disk root")
    train_loader = BatchLoader(
        train_ds, rows, shuffle=True, seed=tc.seed, shard_idx=mesh.data_index,
        num_shards=mesh.data,
        num_threads=tc.num_workers, num_procs=tc.num_procs, n_pack=tc.n_pack,
        pack_bucket=tc.pack_bucket, cache_dir=cache("train"),
        batch_replay_dir=replay_root(tc.cache_dir, tc.seed, shard) if tc.batch_replay else None,
    )
    # val order is fixed, so the val passes after the first stream the
    # materialized collated batches (data/batch_cache.py)
    val_loader = BatchLoader(
        val_ds, rows, shuffle=False, shard_idx=mesh.data_index, num_shards=mesh.data,
        num_threads=tc.num_workers,
        num_procs=tc.num_procs, tight=tc.n_pack > 1, cache_dir=cache("val"),
        batch_cache_dir=cache("val_batches"),
    )

    state = create_train_state(
        model, tc.lr, tc.warmup_steps, sparse_table=tc.sparse_table,
        table_moments_dtype=torch.bfloat16 if tc.table_moments_bf16 else torch.float32)
    if glove_table is not None:
        graft_glove(model, glove_table)

    # the dropout masks: one generator seeded from seed + 1 (and the data
    # rank above bit 32, so that no two data ranks draw the same masks and
    # a model row draws one), its state saved with each checkpoint (the TPU
    # package folds the step into its key)
    rng = torch.Generator(device).manual_seed(tc.seed + 1 + (mesh.data_index << 32))
    start_epoch = 0
    ckpt_dir = f"{tc.output_dir}/checkpoints"
    if tc.resume and latest_epoch(ckpt_dir) is not None:
        state, start_epoch = restore_checkpoint(ckpt_dir, state, generator=rng, mesh=mesh)
        logger.info("resumed from epoch %d", start_epoch)
    shard_state(state, mesh)

    train_step = make_train_step(
        model, state.optimizer, model_cfg, with_milnce=tc.with_milnce,
        sparse_table=tc.sparse_table, mesh=mesh)
    eval_step = make_eval_step(model, model_cfg, with_milnce=tc.with_milnce, mesh=mesh)
    # float32 features ship as bf16 when the model computes in bf16 (exact:
    # the model's own cast rounds identically, data/transfer.py)
    mover = BatchMover(device, bf16_features=model_cfg.compute_dtype == torch.bfloat16)
    timer = StepTimer()

    def device_batches(loader, what, pad=False):
        return lockstep((ship.ready() for _, ship in shipped(loader, mover)), mesh, logger,
                        what, pad)

    # device-resident frozen batches (TrainerConfig.resident_gb): pinned the
    # first epoch after the corresponding cache materializes
    resident_budget = tc.resident_gb * 1e9
    resident_train = resident_val = None

    for epoch in range(start_epoch, tc.num_epochs):
        train_loader.set_epoch(epoch)
        if tc.batch_replay and resident_train is None and resident_budget > 0:
            resident_train = _make_resident(train_loader, mover, resident_budget, logger)
            if resident_train is not None:
                resident_budget -= resident_train[1]
        loss_meter, mil_meter = AverageMeter(), AverageMeter()

        # metrics are read metric_lag steps late, when their copies to pinned
        # memory have landed: reading the current step's would hold the host
        # until the card finished everything queued. Log lines report the
        # step they belong to.
        metric_lag = 4
        pending: deque = deque()

        def drain(i, fetch):
            nonlocal n_samples
            loss, mil, n = (float(v) for v in fetch.result())
            bsz = int(n)
            n_samples += bsz    # valid samples: a packed row holds several
            if bsz:
                loss_meter.update(loss, bsz)
                mil_meter.update(mil, bsz)
            sps = timer.tick()
            if (i + 1) % tc.log_steps == 0:
                logger.info(
                    "Time %s, Epoch [%d/%d], Step [%d], Loss: %s, MIL NCE Loss: %s, "
                    "Avg Loss: %s, Avg MILNCE_loss: %s, steps/s: %s",
                    datetime.datetime.now(), epoch + 1, tc.num_epochs, i + 1,
                    loss, mil, loss_meter.avg, mil_meter.avg, sps,
                )
                metrics_out.log("Avg Loss", loss_meter.avg, int(state.step))
                metrics_out.log("Avg MILNCE_loss", mil_meter.avg, int(state.step))

        if resident_train is not None:
            batches = lockstep((resident_train[0][int(j)] for j in
                                train_loader.replay_order(epoch, len(resident_train[0]))),
                               mesh, logger, "train")
        else:
            batches = device_batches(train_loader, "train")
        tracing = None
        t0 = time.perf_counter()
        n_steps = n_samples = 0
        for i, batch in enumerate(batches):
            if tc.profile_steps and epoch == start_epoch and rank == 0:
                if i == tc.profile_start:
                    tracing = start_trace()
                elif tracing is not None and i == tc.profile_start + tc.profile_steps:
                    stop_trace(tracing, f"{tc.output_dir}/profile")
                    tracing = None
            m = train_step(state, batch, rng)
            pending.append((i, HostFetch(torch.stack(
                [m["loss"].float(), m["mil_nce_loss"].float(), m["n"].float()]))))
            if len(pending) > metric_lag:
                drain(*pending.popleft())
            n_steps += 1
        while pending:
            drain(*pending.popleft())
        seconds = time.perf_counter() - t0
        if tracing is not None:  # epoch shorter than the requested window
            stop_trace(tracing, f"{tc.output_dir}/profile")
        logger.info("Epoch [%d/%d] trained %d steps in %.3f s: %.3f steps/s, %.1f samples/s",
                    epoch + 1, tc.num_epochs, n_steps, seconds, n_steps / max(seconds, 1e-9),
                    n_samples / max(seconds, 1e-9))

        # eval on val and train every eval_every epochs (`main:380-382`);
        # the final epoch always evals
        if (epoch + 1) % tc.eval_every and epoch + 1 != tc.num_epochs:
            if (epoch + 1) % tc.checkpoint_every == 0:
                save_checkpoint(ckpt_dir, state, epoch + 1, tc.max_checkpoints, rng, mesh)
            continue
        if resident_val is None and resident_budget > 0:
            # materializes on the first (streamed) val pass, resident after
            resident_val = _make_resident(val_loader, mover, resident_budget, logger)
            if resident_val is not None:
                resident_budget -= resident_val[1]
        val_loss, val_corr, val_n = run_eval(
            eval_step, state,
            lockstep(resident_val[0], mesh, logger, "val", pad=True)
            if resident_val is not None else device_batches(val_loader, "val", pad=True),
            logger, tc.log_steps_val, "val")
        # train eval reuses the resident replay batches: the same content,
        # and the order does not change the summed metrics
        train_loss, tr_corr, tr_n = run_eval(
            eval_step, state,
            lockstep(resident_train[0], mesh, logger, "train eval", pad=True)
            if resident_train is not None
            else device_batches(train_loader, "train eval", pad=True),
            logger, tc.log_steps, "train")

        val_acc = val_corr / max(val_n, 1)
        train_acc = tr_corr / max(tr_n, 1)
        logger.info(
            "Time %s, Epoch [%d/%d], Val Loss: %s, accuracy: %s/%s = %s",
            datetime.datetime.now(), epoch + 1, tc.num_epochs, val_loss,
            val_corr, val_n, val_acc,
        )
        logger.info(
            "Time %s, Epoch [%d/%d], Train Loss: %s, accuracy: %s/%s = %s",
            datetime.datetime.now(), epoch + 1, tc.num_epochs, train_loss,
            tr_corr, tr_n, train_acc,
        )
        metrics_out.log("Test Acc", val_acc, epoch + 1)
        metrics_out.log("Train Acc", train_acc, epoch + 1)

        if (epoch + 1) % tc.checkpoint_every == 0:
            save_checkpoint(ckpt_dir, state, epoch + 1, tc.max_checkpoints, rng, mesh)

    return state


def _make_resident(loader: BatchLoader, mover: BatchMover, budget_bytes: float,
                   logger) -> Optional[tuple]:
    """Ship a loader's materialized frozen batches to the device once.

    Returns ``(device batches, bytes)`` (index i = cache batch i), or None
    when there is no valid cache yet or the batches exceed the budget.
    Afterwards an epoch copies nothing to the device. The training step
    writes into no batch, so resident batches serve every step and epoch.
    """
    cache = loader.replay_cache()
    if cache is None or budget_bytes <= 0:
        return None
    total = 0
    for i in range(len(cache)):
        total += _device_bytes(cache.batch(i), mover.bf16_features)
        if total > budget_bytes:
            logger.info(
                "resident batches over budget (%.1f GB > %.1f GB) at %d/%d; streaming",
                total / 1e9, budget_bytes / 1e9, i + 1, len(cache),
            )
            return None
    dev = [ship.ready() for _, ship in shipped(iter(cache), mover)]
    logger.info("pinned %d frozen batches device-resident (%.2f GB)", len(dev), total / 1e9)
    return dev, total


def _device_bytes(batch, bf16_features: bool) -> int:
    """Bytes of a collated batch once shipped: float32 features as bf16 when
    the mover casts them, the other fields as collated."""
    n = 0
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is not None:
            n += v.nbytes // (2 if bf16_features and f.name == "vis_fea" else 1)
    return n


@torch.no_grad()
def graft_glove(model: torch.nn.Module, table: np.ndarray) -> None:
    """Copy GloVe vectors into rows [0, n) of every GloVe table of ``model``
    (``modules()`` yields the shared one once), the post-init counterpart of
    ``AttModel_x3.py:38``."""
    src = torch.from_numpy(np.asarray(table, np.float32))
    for m in model.modules():
        if isinstance(m, GloVeEmbed) and m.weight.shape[0] >= src.shape[0]:
            m.weight[: src.shape[0]].copy_(src)
