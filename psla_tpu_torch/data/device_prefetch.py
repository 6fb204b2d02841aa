"""Input prefetch to the card: overlap the host-to-card copy with compute
(port of ``psla_tpu/data/device_prefetch.py``).

The reference's input overlap ends at the host (torch DataLoader workers
produce CPU tensors; the copy to the GPU serializes with the training step,
src/traintest.py:81-84). Here a background thread copies each host batch
into a ring of pinned host buffers and issues its copy to the card on a
side CUDA stream, ``depth`` batches ahead of the step that reads it, so the
copy of batch k+1 runs under batch k's kernels:

  * the ring holds ``depth + 1`` pinned buffers per field, allocated once
    (at the first batch): ``depth`` batches wait in the queue while the
    producer fills the next one;
  * a buffer is refilled only after the copy out of it has finished (the
    producer waits on that copy's event);
  * the consumer's stream waits on the copy's event before it reads the
    batch, and each card tensor is recorded on that stream
    (``record_stream``), so the caching allocator does not hand its memory
    to the side stream while the step still reads it.

On a CPU device the batches are only turned into tensors. ``depth <= 0``
runs every copy in line (pageable), as the JAX function's serial path does.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch

from psla_tpu_torch.frontend.pipeline import WavBatch
from psla_tpu_torch.tracing import span

# the fields a step reads; the rest of a host batch ('n_valid') stays on
# the host
BATCH_FIELDS = WavBatch._fields


def to_device(host_batch: Mapping[str, np.ndarray], device: torch.device
              ) -> dict[str, torch.Tensor]:
    """The batch's fields as tensors on ``device``, copied in line."""
    return {k: torch.as_tensor(host_batch[k]).to(device) for k in BATCH_FIELDS}


class _PinnedRing:
    """Pinned host buffers and the side stream that copies them to the card."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.slots: list[dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self.done: list[torch.cuda.Event | None] = [None] * slots
        self.next = 0

    def put(self, host_batch: Mapping[str, np.ndarray]):
        """Stage one batch: fill the next pinned slot and copy it to the
        card on the side stream. Returns (card tensors, copy event)."""
        i = self.next
        self.next = (i + 1) % len(self.slots)
        if self.done[i] is not None:
            self.done[i].synchronize()  # the slot's last copy has finished
        slot = self.slots[i]
        for k in BATCH_FIELDS:
            src = torch.from_numpy(np.ascontiguousarray(host_batch[k]))
            buf = slot.get(k)
            if buf is None:
                buf = slot[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            elif buf.shape != src.shape or buf.dtype != src.dtype:
                raise ValueError(f"batch field {k!r} changed from {tuple(buf.shape)} "
                                 f"{buf.dtype} to {tuple(src.shape)} {src.dtype}")
            buf.copy_(src)
        with torch.cuda.stream(self.stream):
            out = {k: slot[k].to(self.device, non_blocking=True) for k in BATCH_FIELDS}
            event = torch.cuda.Event()
            event.record(self.stream)
        self.done[i] = event
        return out, event

    def ready(self, batch: dict[str, torch.Tensor], event: torch.cuda.Event
              ) -> dict[str, torch.Tensor]:
        """Order the consumer's stream after the batch's copy."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in batch.values():
            t.record_stream(stream)
        return batch


def prefetch_to_device(
    host_batches: Iterable[Mapping[str, np.ndarray]],
    device: str | torch.device,
    depth: int = 2,
) -> Iterator[tuple[Mapping[str, np.ndarray], dict[str, torch.Tensor]]]:
    """Yield ``(host_batch, device_batch)`` pairs in loader order.

    ``device_batch`` holds the eight WavBatch fields as tensors on
    ``device``; the host batch comes alongside because the loops read its
    host-side metadata ('n_valid', the labels of the valid rows). Up to
    ``depth`` batches are staged ahead on a daemon thread. A producer
    exception re-raises in the consumer at the failing position. Leaving
    the iterator (an early break, an error) stops the producer, which
    closes ``host_batches``.
    """
    device = torch.device(device)
    if depth <= 0:
        for hb in host_batches:
            yield hb, to_device(hb, device)
        return
    ring = _PinnedRing(device, depth + 1) if device.type == "cuda" else None

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def enqueue(item) -> bool:
        # a bounded put that notices an abandoned consumer
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for hb in host_batches:
                if stop.is_set():
                    return
                with span("prefetch.stage"):
                    staged = ring.put(hb) if ring is not None else (to_device(hb, device), None)
                if not enqueue((hb, *staged)):
                    return
            enqueue(None)
        except BaseException as e:  # re-raised at the consumer's position
            enqueue(e)
        finally:
            close = getattr(host_batches, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=producer, daemon=True, name="psla-torch-device-prefetch")
    t.start()
    try:
        while True:
            with span("prefetch.wait"):  # from asking for a batch until it can be read
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                hb, batch, event = item
                if ring is not None:
                    batch = ring.ready(batch, event)
            yield hb, batch
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
