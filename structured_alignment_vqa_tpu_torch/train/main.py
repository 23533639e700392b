"""The training CLI (counterpart of the TPU package's ``train/main.py``):
``build_parser`` accepts every flag of the TPU package's parser with the
same defaults, including the Azure env-var defaults PT_DATA_DIR /
PT_OUTPUT_DIR, ``configs_from_args`` turns them into the port's
configurations, and ``main`` trains (``train/loop.py:train``). The eval and
predict CLIs build on the parser and the configurations.

Usage:
    python -m structured_alignment_vqa_tpu_torch.train.main \
        --data_dir_azure /data/gqa --output_dir run ... --share_glove --bf16

``--platform cpu`` runs on the CPU; any other value, or none, runs on the
CUDA card and fails without one. ``--bf16`` computes in torch.bfloat16.
``--use_pallas`` has no counterpart (the port launches its kernels on every
CUDA tensor); the eval and predict CLIs log it as having no effect.
``--n_pack N --pack_bucket I`` packs up to N training samples a row;
``--mcb`` builds the MCB head.

The model axis: ``--model_parallel N`` splits the parameters over N ranks
a data row (``parallel/sharding.py:param_pspec``), the ranks of a row
taking the same samples; each invocation starts N ranks for every data
rank (N gloo ranks on the CPU with ``--platform cpu``), rank r at data
``r // N`` and model ``r % N``. Where N splits the attention projections'
columns but not the heads (8 heads over 16 ranks at hidden 512), a head
spans ranks and each rank computes the heads its columns overlap
(``ops/attention.py``), as the TPU package's GSPMD reshards them.

Data parallel: each invocation starts one rank per visible card, as many
as divide ``--batch_size`` (the TPU package's ``fitting_mesh`` rule, which
warns about idle cards), over NCCL; with ``--platform cpu``, or one usable
card, it runs in this process with no group. Each rank takes
``--batch_size / ranks a host`` rows a step, so a step takes
``--batch_size`` samples a host. Without ``--coordinator`` the ranks are
those of this host alone, joined at a local port. Over hosts,
``--coordinator host0:port --num_processes H --process_id h`` keep the TPU
package's meaning, one invocation a host, global rank ``h * ranks a host +
local rank``; with ``--platform cpu`` one gloo rank a host.
``--coordinator`` with ``--num_processes 1`` forms a group of the host's
ranks alone even when it has one.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from structured_alignment_vqa_tpu_torch.data.dataset import DataConfig
from structured_alignment_vqa_tpu_torch.data.vocab import load_answer_vocab
from structured_alignment_vqa_tpu_torch.device import resolve_device
from structured_alignment_vqa_tpu_torch.models.config import ModelConfig
from structured_alignment_vqa_tpu_torch.models.glove import build_glove_table
from structured_alignment_vqa_tpu_torch.parallel.mesh import (
    check_axes,
    fitting_data_size,
    free_ports,
    init_distributed,
    shutdown,
)
from structured_alignment_vqa_tpu_torch.train.loop import TrainerConfig, train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SA-VQA training driver (PyTorch/CUDA port)")
    # data paths (reference defaults, `main:435-450`)
    p.add_argument("--data_dir_azure", type=str, default=os.environ.get("PT_DATA_DIR", "./tmp"))
    p.add_argument("--fea_tar_fn_train", default="gt_bua_npz.tar")
    p.add_argument("--q_tar_fn_train", default="train.tar")
    p.add_argument("--g_tar_fn_train", default="gt_bua_npz.tar")
    p.add_argument("--fea_tar_fn_val", default="gt_bua_npz.tar")
    p.add_argument("--q_tar_fn_val", default="val.tar")
    p.add_argument("--g_tar_fn_val", default="gt_bua_npz.tar")
    p.add_argument("--gt_relation_fn", default="GT_relations_dict_compsite.json")
    p.add_argument("--obj_vocab_fn", type=str, default="objects_vocab.txt")
    p.add_argument("--attr_vocab_fn", type=str, default="attributes_vocab.txt")
    p.add_argument("--bbox_bin_num", type=int, default=64)
    p.add_argument("--enc_vocab_fn", type=str, default="preprocessed/de.vocab.composite2.tsv")
    p.add_argument("--ans_vocab_fn", type=str, default="preprocessed/en.vocab.tsv")
    p.add_argument("--glove_path", type=str, default=None,
                   help="GloVe .txt/.npy; defaults to <data_dir>/vector_cache if present")

    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--output_dir", type=str, default=os.environ.get("PT_OUTPUT_DIR", "./tmp"))

    # model hyperparameters (`main:457-469`)
    p.add_argument("--maxlen", type=int, default=300)
    p.add_argument("--maxlen_q", type=int, default=50)
    p.add_argument("--maxlen_v", type=int, default=49)
    p.add_argument("--hidden_size", type=int, default=512)
    p.add_argument("--hidden_size_mil", type=int, default=64)
    p.add_argument("--num_blocks", type=int, default=6)
    p.add_argument("--num_epochs", type=int, default=40)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--min_cnt", type=int, default=10)
    p.add_argument("--dropout_rate", type=float, default=0.5)
    p.add_argument("--dropout_rate_mcb", type=float, default=0.1)
    p.add_argument("--aug_rate", type=float, default=0.5)
    p.add_argument("--topN", type=int, default=1)

    # variant switches (`main:471-488`)
    for flag in (
        "sinusoid", "with_dec", "with_loc", "with_smooth_labeling", "with_bbox",
        "with_rank_loss", "with_MILNCE_loss", "with_gt_relation", "local_debug",
        "decMask", "visGraph", "mcb", "dataAug", "gtNode", "gtWpred",
        "GTRelPredNode", "only_obj", "pred_rel",
    ):
        p.add_argument(f"--{flag}", action="store_true")

    p.add_argument("--log_steps", type=int, default=100)
    p.add_argument("--log_steps_val", type=int, default=100)
    p.add_argument("--model_v", type=int, default=3)
    p.add_argument("--pool", type=str, default="mean")

    # distributed (the reference: ngpus/nr/num_nodes; here one invocation a
    # host, one rank per card)
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 for multi-host init")
    p.add_argument("--num_processes", type=int, default=1,
                   help="hosts, one invocation each")
    p.add_argument("--process_id", type=int, default=0,
                   help="this host's index among them")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=8,
                   help="loader threads")
    p.add_argument("--no_resume", action="store_true")

    p.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype")
    p.add_argument("--share_glove", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab_size", type=int, default=407000,
                   help="GloVe-backed embedding rows (reference: 407000)")
    p.add_argument("--glove_dim", type=int, default=300)
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs on the CPU; anything else, or nothing, on the "
                        "CUDA card (and fails without one)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a profiler trace over N training steps")
    p.add_argument("--n_pack", type=int, default=1,
                   help="sequence packing: up to N training samples per row "
                        "(data/packing.py); eval of val then uses the tight collate")
    p.add_argument("--pack_bucket", type=int, default=-1,
                   help="bucket index packed rows use (-1 = largest)")
    p.add_argument("--num_procs", type=int, default=0,
                   help="loader worker processes, spawned (0 = thread pool)")
    p.add_argument("--cache_dir", type=str, default="",
                   help="cross-epoch preprocessed-sample cache directory: the "
                        "first pass persists converted samples; later passes "
                        "stream mmap'd arrays (data/sample_cache.py)")
    p.add_argument("--batch_replay", action="store_true",
                   help="materialize epoch-0's collated train batches and "
                        "replay them in a per-epoch-shuffled order (frozen "
                        "composition; needs --cache_dir)")
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="epochs between checkpoints (reference saves every epoch)")
    p.add_argument("--max_checkpoints", type=int, default=0,
                   help="keep only the newest N checkpoints (0 = keep all, "
                        "the reference behavior)")
    p.add_argument("--eval_every", type=int, default=1,
                   help="epochs between val/train eval passes (reference: 1; "
                        "the final epoch always evals)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps before the constant reference "
                        "LR (0 = reference behavior, no warmup)")
    p.add_argument("--use_pallas", action="store_true",
                   help="the TPU package's Pallas switch; no effect here (the "
                        "port launches its CUDA kernels on every CUDA tensor)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder block's activations in the "
                        "backward instead of saving them")
    p.add_argument("--sparse_table", action="store_true",
                   help="lazy sparse Adam for the shared GloVe table: only the "
                        "rows a batch touches are read and updated (needs "
                        "--share_glove; parallel/sparse_table.py)")
    p.add_argument("--table_moments_bf16", action="store_true",
                   help="bfloat16 Adam moments for the sparse table")
    p.add_argument("--resident_gb", type=float, default=8.0,
                   help="device-memory budget (GB) for the frozen batches of "
                        "--batch_replay and the val batch cache, shipped to the "
                        "device once (0 streams them every epoch)")
    return p


def check_supported_flags(args) -> None:
    """Raise ``ValueError`` for axis sizes the mesh cannot take
    (``parallel/mesh.py:check_axes``) and for several hosts without a
    coordinator."""
    check_axes(model_parallel=args.model_parallel, hidden_size=args.hidden_size,
               num_heads=args.num_heads)
    if args.num_processes > 1 and not args.coordinator:
        raise ValueError("--num_processes > 1 needs --coordinator (host:port of process 0)")


def local_ranks(args) -> int:
    """The ranks this invocation starts: ``--model_parallel`` on the CPU,
    else one per visible card, as many data rows of ``--model_parallel``
    cards as divide ``--batch_size``."""
    m = args.model_parallel
    if args.platform == "cpu":
        return m
    resolve_device(None)
    cards = torch.cuda.device_count()
    if cards < m:
        raise ValueError(f"--model_parallel {m} needs {m} cards; this host has {cards}")
    return fitting_data_size(cards, args.batch_size, model_parallel=m) * m


def run_ranks(args, entry):
    """``entry(args, mesh)`` on this invocation's ``local_ranks(args)`` ranks.

    Without ``--coordinator`` and with one local rank: once, in this
    process, with no mesh. Otherwise each local rank joins a group and
    calls ``entry`` with its mesh: with ``--coordinator``, the group of
    ``num_processes * local ranks`` ranks there; without, the group of
    this host's ranks alone at a local port found here once, before any
    rank starts (``--coordinator 127.0.0.1:<port> --num_processes 1
    --process_id 0``). One local rank runs in this process (and its result
    is returned), several are spawned processes (None is returned).
    ``entry`` must be a module-level function, so that spawned ranks can
    import it.
    """
    n_local = local_ranks(args)
    group = (args.coordinator, args.num_processes, args.process_id)
    if not args.coordinator:
        if n_local == 1:
            return entry(args, None)
        group = (f"127.0.0.1:{free_ports()[0]}", 1, 0)
    if n_local == 1:
        return _rank(0, args, entry, 1, group)
    torch.multiprocessing.spawn(_rank, args=(args, entry, n_local, group), nprocs=n_local)
    return None


def _rank(local_rank: int, args, entry, n_local: int, group: tuple):
    coordinator, num_processes, process_id = group
    mesh = init_distributed(
        coordinator, num_processes * n_local, process_id * n_local + local_rank,
        device="cpu" if args.platform == "cpu" else None, local_rank=local_rank,
        local_world=n_local, model_parallel=args.model_parallel)
    try:
        return entry(args, mesh)
    finally:
        shutdown(mesh)


def device_from_args(args) -> torch.device:
    """``--platform cpu`` is the CPU; anything else is the CUDA card, and
    raises if there is none."""
    return resolve_device("cpu" if args.platform == "cpu" else None)


def log_flags_without_effect(args, logger) -> None:
    if args.use_pallas:
        logger.info("--use_pallas has no effect in the port: its CUDA kernels run on "
                    "every CUDA tensor")


def configs_from_args(args) -> tuple[ModelConfig, DataConfig, DataConfig, TrainerConfig]:
    check_supported_flags(args)
    d = args.data_dir_azure
    w2idx, _ = load_answer_vocab(os.path.join(d, args.ans_vocab_fn), args.min_cnt)
    num_classes = len(w2idx) + 1  # + "all other" class (`main:183`)

    with open(os.path.join(d, args.gt_relation_fn)) as f:
        gt_relations = json.load(f)
    num_relations = len(set(gt_relations.values())) + 1  # + no-relation (`main:195`)

    model_cfg = ModelConfig(
        num_classes=num_classes,
        num_relations=num_relations,
        vocab_size=args.vocab_size,
        glove_dim=args.glove_dim,
        hidden_size=args.hidden_size,
        hidden_size_mil=args.hidden_size_mil,
        num_blocks=args.num_blocks,
        # the reference hardcodes stages [0,2), [2,4), [4,N) (`AttModel_x3.py:127-139`);
        # clamp for small block counts
        stage1_blocks=min(2, args.num_blocks),
        stage2_blocks=min(4, args.num_blocks),
        num_heads=args.num_heads,
        dropout_rate=args.dropout_rate,
        dropout_rate_mcb=args.dropout_rate_mcb,
        maxlen=args.maxlen,
        maxlen_q=args.maxlen_q,
        maxlen_v=args.maxlen_v,
        topn=args.topN,
        only_obj=args.only_obj,
        use_dec_mask=args.decMask,
        use_mcb=args.mcb,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        share_glove=args.share_glove,
        remat_blocks=args.remat,
    )

    def data_cfg(fea, q, g):
        return DataConfig(
            data_dir=d, fea_tar=fea, q_tar=q, g_tar=g,
            gt_relation_fn=args.gt_relation_fn,
            obj_vocab_fn=args.obj_vocab_fn, attr_vocab_fn=args.attr_vocab_fn,
            enc_vocab_fn=args.enc_vocab_fn, ans_vocab_fn=args.ans_vocab_fn,
            bbox_bin_num=args.bbox_bin_num, min_cnt=args.min_cnt,
            maxlen=args.maxlen, topn=args.topN, with_loc=args.with_loc,
            only_obj=args.only_obj, pred_rel=args.pred_rel, seed=args.seed,
        )

    train_dc = data_cfg(args.fea_tar_fn_train, args.q_tar_fn_train, args.g_tar_fn_train)
    val_dc = data_cfg(args.fea_tar_fn_val, args.q_tar_fn_val, args.g_tar_fn_val)

    trainer_cfg = TrainerConfig(
        output_dir=os.path.join(d, args.output_dir) if not os.path.isabs(args.output_dir) else args.output_dir,
        batch_size=args.batch_size,
        lr=args.lr,
        num_epochs=args.num_epochs,
        log_steps=args.log_steps,
        log_steps_val=args.log_steps_val,
        with_milnce=args.with_MILNCE_loss,
        model_parallel=args.model_parallel,
        seed=args.seed,
        resume=not args.no_resume,
        num_workers=args.num_workers,
        num_procs=args.num_procs,
        n_pack=args.n_pack,
        pack_bucket=None if args.pack_bucket < 0 else args.pack_bucket,
        cache_dir=args.cache_dir or None,
        batch_replay=args.batch_replay,
        profile_steps=args.profile_steps,
        eval_every=args.eval_every,
        warmup_steps=args.warmup_steps,
        sparse_table=args.sparse_table,
        table_moments_bf16=args.table_moments_bf16,
        resident_gb=args.resident_gb,
        checkpoint_every=args.checkpoint_every,
        max_checkpoints=args.max_checkpoints or None,
    )
    return model_cfg, train_dc, val_dc, trainer_cfg


def main(argv=None):
    """Train from the flags; returns the final ``TrainState`` (rank 0's, or
    None when the ranks run in spawned processes). The GloVe vectors come
    from ``--glove_path`` or else
    ``<data_dir>/vector_cache/glove.6B.300d.{npy,txt}`` when present."""
    args = build_parser().parse_args(argv)
    if args.model_v != 3:
        raise SystemExit(
            "model_v != 3: use structured_alignment_vqa_tpu_torch.models.variants to "
            "instantiate ablation models; the training driver covers the production v3 "
            "path (as does the reference's maintained loss branch).")
    check_supported_flags(args)
    return run_ranks(args, train_from_args)


def train_from_args(args, mesh=None):
    """One rank's training run (:func:`run_ranks`)."""
    model_cfg, train_dc, val_dc, trainer_cfg = configs_from_args(args)
    glove_path = args.glove_path
    if glove_path is None:
        for cand in ("glove.6B.300d.npy", "glove.6B.300d.txt"):
            c = os.path.join(args.data_dir_azure, "vector_cache", cand)
            if os.path.exists(c):
                glove_path = c
                break
    glove_table = build_glove_table(glove_path=glove_path) if glove_path else None
    return train(model_cfg, train_dc, trainer_cfg, val_data_cfg=val_dc,
                 glove_table=glove_table,
                 device=device_from_args(args) if mesh is None else None, mesh=mesh)


if __name__ == "__main__":
    main()
