"""Job launcher (counterpart of the TPU package's ``train/launch.py``; the
reference's ``models/submit.py``).

The reference submits an Azure ML job (8xV100 nodes, MPI launcher,
``submit.py:120-135``) with a production hyperparameter dict
(``submit.py:72-118``). Here the launcher builds the training CLI's command
line from the same presets and, for GPU hosts, one ``ssh`` command a host
carrying ``--coordinator host0:port --num_processes H --process_id h``;
each invocation then starts one rank per card of its host
(``train/main.py``). Without ``--hosts`` the command runs here. No
credentials live in this file.

Usage:
    python -m structured_alignment_vqa_tpu_torch.train.launch --preset obj_only \
        --data_dir /data/gqa --hosts gpu0,gpu1 --dry_run
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from typing import Dict, List, Optional

# Production hyperparameters (`submit.py:72-118`): batch 32 / maxlen 450 /
# hidden_size_mil 1024 for obj-only; batch 4 / maxlen 1600 / mil 64 for
# obj+rel. Flags present with empty value in the reference dict are
# store-true switches. The TPU package's presets, entry for entry.
PRESETS: Dict[str, Dict] = {
    "obj_only": {
        "batch_size": 32, "model_v": 3, "maxlen": 450, "maxlen_q": 40,
        "num_blocks": 6, "min_cnt": 50, "dropout_rate": 0.5, "topN": 5,
        "hidden_size_mil": 1024, "log_steps": 100,
        "flags": ["with_loc", "with_dec", "with_bbox", "with_smooth_labeling",
                  "decMask", "with_MILNCE_loss", "only_obj", "pred_rel"],
    },
    "obj_rel": {
        "batch_size": 4, "model_v": 3, "maxlen": 1600, "maxlen_q": 40,
        "num_blocks": 6, "min_cnt": 50, "dropout_rate": 0.5, "topN": 5,
        "hidden_size_mil": 64, "log_steps": 100,
        # use_pallas has no effect in the port (its kernels always run on
        # the card); kept so that the argv equals the TPU package's
        "flags": ["with_loc", "with_dec", "with_bbox", "with_smooth_labeling",
                  "decMask", "with_MILNCE_loss", "pred_rel", "use_pallas"],
    },
}

MODULE = "structured_alignment_vqa_tpu_torch.train.main"


def build_train_argv(preset: str, data_dir: str, output_dir: str, extra: List[str]) -> List[str]:
    p = PRESETS[preset]
    argv = [sys.executable, "-m", MODULE, "--data_dir_azure", data_dir,
            "--output_dir", output_dir]
    for k, v in p.items():
        if k != "flags":
            argv += [f"--{k}", str(v)]
    argv += [f"--{f}" for f in p["flags"]]
    return argv + extra


def host_commands(argv: List[str], hosts: List[str], port: int,
                  repo_dir: str) -> List[List[str]]:
    """One ``ssh`` command a host: host ``h`` runs ``argv`` from
    ``repo_dir`` as process ``h`` of ``len(hosts)``, all meeting at the
    first host's ``port``."""
    coordinator = f"{hosts[0]}:{port}"
    out = []
    for h, host in enumerate(hosts):
        remote = argv + ["--coordinator", coordinator, "--num_processes", str(len(hosts)),
                         "--process_id", str(h)]
        line = " ".join(shlex.quote(a) for a in remote)
        out.append(["ssh", host, f"cd {shlex.quote(repo_dir)} && {line}"])
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description="SA-VQA training job launcher (PyTorch/CUDA port)")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="obj_only")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--output_dir", default="output_supernode")
    ap.add_argument("--hosts", default=None,
                   help="comma-separated GPU hosts, the first the coordinator; omit to run here")
    ap.add_argument("--port", type=int, default=29500, help="the coordinator's port")
    ap.add_argument("--repo_dir", default="structured-alignment-vqa-tpu",
                    help="the checkout on every host (relative: to the login directory)")
    ap.add_argument("--dry_run", action="store_true", help="print the commands, run nothing")
    ap.add_argument("extra", nargs="*", help="extra flags passed to the trainer")
    args = ap.parse_args(argv)

    train_argv = build_train_argv(args.preset, args.data_dir, args.output_dir, args.extra)
    cmds = (host_commands(train_argv, args.hosts.split(","), args.port, args.repo_dir)
            if args.hosts else [train_argv])
    printable = [" ".join(shlex.quote(c) for c in cmd) for cmd in cmds]
    if args.dry_run:
        for line in printable:
            print(line)
        return printable
    for line in printable:
        print(f"launching: {line}", file=sys.stderr)
    procs = [subprocess.Popen(cmd) for cmd in cmds]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    main()
