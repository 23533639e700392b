"""Move a collated numpy batch to the device (the port's counterpart of the
TPU package's ``data/wire.py``).

The TPU package packs a batch into three dtype-grouped arrays because each
host-to-device put pays a fixed cost there. On a CUDA card each field's copy
is one ``cudaMemcpyAsync``; what matters is that the copies overlap the
compute of earlier batches, so the fields travel as they are:

* each field is copied into page-locked (pinned) host memory, then to the
  card with ``non_blocking=True`` on a side CUDA stream, so the copy runs
  while the compute stream works;
* an event recorded on the side stream after the last copy is what the
  compute stream waits on (:meth:`ShippedBatch.ready`), and each device
  tensor is marked as used by the compute stream (``record_stream``), so the
  caching allocator does not hand its memory out again before the compute
  that reads it has finished;
* the pinned buffers belong to the :class:`ShippedBatch`; PyTorch's caching
  host allocator also records each asynchronous copy's stream, so a pinned
  block is not reused before its copy is done, whenever its tensor is freed;
* with ``bf16_features`` the float32 features ship as bfloat16, as
  ``pack_wire(bf16_features=True)`` does: half the bytes, and exact when
  the model computes in bfloat16, since it casts ``vis_fea`` to the compute
  dtype at both of its uses (``models/att_model_x3.py``). Callers gate it
  on the compute dtype.

Masks and graphs travel as the int8 collate makes, ids as int32
(``data/batch.py`` lists what arrives). On the CPU a batch is
``torch.from_numpy`` of each field: no pinning, no stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from structured_alignment_vqa_tpu_torch.data.batch import VQABatch

SHIP_AHEAD = 2   # batches :func:`shipped` copies ahead of the consumer


def _fields(batch: VQABatch):
    for f in dataclasses.fields(VQABatch):
        value = getattr(batch, f.name)
        if value is not None:
            yield f.name, value


def _wire_dtype(name: str, t: torch.Tensor, bf16_features: bool) -> torch.dtype:
    return torch.bfloat16 if name == "vis_fea" and bf16_features else t.dtype


def host_tensors(batch: VQABatch, bf16_features: bool = False) -> VQABatch:
    """The batch as CPU tensors: ``torch.from_numpy`` of each field (no copy),
    ``vis_fea`` cast to bfloat16 when ``bf16_features``."""
    out = {}
    for name, value in _fields(batch):
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[name] = t.to(_wire_dtype(name, t, bf16_features))
    return VQABatch(**out)


@dataclasses.dataclass
class ShippedBatch:
    """A batch on its way to the device: its device tensors, the event that
    fires when their copies are done (None on the CPU), and the pinned host
    buffers they were copied from."""

    batch: VQABatch
    event: Optional[torch.cuda.Event]
    pinned: Tuple[torch.Tensor, ...]
    nbytes: int

    def ready(self) -> VQABatch:
        """Make the current (compute) stream wait for the copies and return
        the batch. No host synchronisation."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.batch.vis_fea.device)
            stream.wait_event(self.event)
            for _, t in _fields(self.batch):
                t.record_stream(stream)
        return self.batch


class BatchMover:
    """Ships collated numpy batches to ``device``; call :meth:`ship` from one
    thread (the shipper), :meth:`ShippedBatch.ready` from the compute one."""

    def __init__(self, device, bf16_features: bool = False):
        self.device = torch.device(device)
        self.bf16_features = bf16_features
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)

    def ship(self, batch: VQABatch) -> ShippedBatch:
        if self.stream is None:
            host = host_tensors(batch, self.bf16_features)
            nbytes = sum(t.numel() * t.element_size() for _, t in _fields(host))
            return ShippedBatch(host.to(self.device), None, (), nbytes)
        pinned, moved = [], {}
        with torch.cuda.stream(self.stream):
            for name, value in _fields(batch):
                t = torch.from_numpy(np.ascontiguousarray(value))
                # one host pass: the copy into the pinned buffer also casts
                buf = torch.empty(t.shape, dtype=_wire_dtype(name, t, self.bf16_features),
                                  pin_memory=True)
                buf.copy_(t)
                pinned.append(buf)
                moved[name] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        nbytes = sum(b.numel() * b.element_size() for b in pinned)
        return ShippedBatch(VQABatch(**moved), event, tuple(pinned), nbytes)


def shipped(loader, mover: BatchMover):
    """Yield ``(host_batch, ShippedBatch)`` for each batch of ``loader``,
    shipped on one worker thread ``SHIP_AHEAD`` batches ahead of the consumer, so
    the copies overlap the compute of the batches before them. The loader
    itself (collate included) runs on the calling thread, as in the TPU
    package's serving loop."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as ex:
        ahead: deque = deque()
        for batch in loader:
            ahead.append((batch, ex.submit(mover.ship, batch)))
            if len(ahead) >= SHIP_AHEAD:
                host, fut = ahead.popleft()
                yield host, fut.result()
        while ahead:
            host, fut = ahead.popleft()
            yield host, fut.result()


class HostFetch:
    """A device tensor's copy into pinned host memory, started without
    blocking the host; :meth:`result` waits for that copy alone (an event
    recorded after it), not for work queued later. On the CPU the tensor is
    its own result."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
