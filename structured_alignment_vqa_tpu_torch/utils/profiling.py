"""Profiling hooks (counterpart of the TPU package's ``utils/profiling.py``;
the reference had none, SURVEY.md section 5.1): ``torch.profiler`` traces
in place of ``jax.profiler``'s, and a step timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile


def start_trace() -> profile:
    """Start recording host ops and, where a card is present, its kernels."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace (chrome://tracing, Perfetto)
    under ``log_dir``; returns the file's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the body into a Chrome trace under ``log_dir`` (nothing when
    ``log_dir`` is empty)."""
    if not log_dir:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


class StepTimer:
    """Steps/sec over a sliding window; call ``tick()`` once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        self._times.append(now)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 2:
            return None
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])
