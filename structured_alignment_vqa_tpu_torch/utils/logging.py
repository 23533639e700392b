"""Logging / observability: the port's own copy of the TPU package's
``utils/logging.py``.

The reference logs through three channels (`SURVEY.md` section 5.5): rank-0 python
logging to ``training.log`` + console, periodic stdout prints, and Azure ML
``Run.log`` metric streaming. Here: the same file+console logger on process 0,
plus a pluggable metric sink (JSONL by default) replacing the Azure channel.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Optional


def setup_logging(output_dir: str, process_index: int = 0) -> logging.Logger:
    """File + console logging on process 0; elsewhere warnings and errors
    only, on the console (`main_itp_ddp_tar_super_node.py:160-171`)."""
    logger = logging.getLogger("savqa")
    logger.setLevel(logging.INFO if process_index == 0 else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(name)-12s %(levelname)-8s %(message)s", "%m-%d %H:%M")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if process_index == 0 and output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "training.log"), mode="w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def _load_metric_hook():
    """External experiment-tracker hook (the Azure ``Run.log`` slot).

    ``SAVQA_METRIC_HOOK=package.module:function`` names a callable taking
    ``(name: str, value: float, step: int | None)``; every MetricLogger.log
    on process 0 forwards to it — wandb/mlflow/Azure adapters are a
    three-line user module away, no framework change needed. Mirrors the
    reference's Azure ML streaming (`main_itp_ddp_tar_super_node.py:147,
    372-373,422-423`). Import errors raise at startup (a silently-dead
    tracker is worse than a crash); hook exceptions at log time are
    swallowed after a one-time warning, so a flaky tracker cannot kill a
    training run the way a dropped Azure connection could.
    """
    spec = os.environ.get("SAVQA_METRIC_HOOK")
    if not spec:
        return None
    import importlib

    mod_name, _, fn_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name or "log_metric")


class MetricLogger:
    """Metric stream -> JSONL file + optional external tracker hook
    (replacement for Azure ``Run.log``, `main:372-373,422-423`)."""

    def __init__(self, output_dir: Optional[str], process_index: int = 0):
        self._path = None
        self._hook = None
        self._hook_warned = False
        if process_index == 0:
            self._hook = _load_metric_hook()
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                self._path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, name: str, value: float, step: Optional[int] = None):
        if self._hook is not None:
            try:
                self._hook(name, float(value), step)
            except Exception:  # noqa: BLE001 — tracker failures must not kill training
                if not self._hook_warned:
                    logging.getLogger("savqa").warning(
                        "metric hook raised; further hook errors suppressed",
                        exc_info=True,
                    )
                    self._hook_warned = True
        if self._path is None:
            return
        rec = {"time": datetime.datetime.now().isoformat(), "name": name, "value": float(value)}
        if step is not None:
            rec["step"] = int(step)
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
