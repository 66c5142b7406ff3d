"""The double-buffered host-to-device stage (port of
``paddle_tpu/io/dataloader.py``'s ``_DevicePrefetchIter``; the rest of the
module, ``DataLoader`` and its samplers, is not ported, ROADMAP A14)."""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

__all__ = ["_DevicePrefetchIter"]


class _DevicePrefetchIter:
    """Double-buffered async H2D stage (reference:
    python/paddle/io/dataloader/dataloader_iter.py:368, pin-memory + a
    buffer-reader thread hiding ingest behind compute). A dedicated thread
    pulls host batches from ``src`` (a tuple or list of arrays per step,
    or one array), stages them on ``device`` and keeps up to ``depth``
    staged batches queued ahead of the consumer, so the copy of batch N+1
    runs while the step consuming batch N computes.

    On a CUDA device each array is copied into pinned host memory and
    from there with ``non_blocking=True`` on a side stream of the
    iterator's own; an event recorded after a batch's copies is waited on
    by the consumer's current stream when the batch is pulled (the step's
    kernels then read it after its copy, with no host wait), and each
    staged tensor is marked as used on that stream for the caching
    allocator. On the CPU a batch is ``to(device)``. One thread serialises
    the copies, as the JAX iterator does: concurrent copies contend for
    the same link without helping latency. End of ``src`` ends the
    iteration; an error in ``src`` or in staging is raised to the consumer
    at its turn, after which the iteration ends."""

    _END = ("end", None)

    def __init__(self, src, device, depth=2, on_next=None):
        self.q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._src = src
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # observability hook: called with the staged-queue depth after
        # each consumer pull (a queue pinned at 0 = ingest-bound, at
        # depth = compute-bound); must be cheap and never raise
        self._on_next = on_next
        self._thread = threading.Thread(
            target=self._run, name="device-prefetch", daemon=True)
        self._thread.start()

    def _to_device(self, b) -> torch.Tensor:
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(b)))
        if self._stream is None or t.device.type == "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, host_batch):
        """(the staged batch, its tensors, the event after their copies
        or None)."""
        many = isinstance(host_batch, (tuple, list))
        items = tuple(host_batch) if many else (host_batch,)
        if self._stream is None:
            staged = tuple(self._to_device(b) for b in items)
            event = None
        else:
            with torch.cuda.stream(self._stream):
                staged = tuple(self._to_device(b) for b in items)
                event = torch.cuda.Event()
                event.record(self._stream)
        return (staged if many else staged[0]), staged, event

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for host_batch in self._src:
                if self._stop.is_set():
                    return
                if not self._put(("item", self._stage(host_batch))):
                    return
            self._put(self._END)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._put(("err", e))

    def __next__(self):
        # after an error was relayed (or close()), the producer thread
        # is gone and nothing will ever be enqueued again — a blocking
        # get() would deadlock a consumer that catches the error and
        # keeps iterating; terminate the iteration instead
        if self._done:
            raise StopIteration
        while True:
            try:
                kind, payload = self.q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._done = True
                    raise StopIteration from None
        if kind == "item":
            batch, tensors, event = payload
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in tensors:
                    t.record_stream(stream)
            if self._on_next is not None:
                self._on_next(self.q.qsize())
            return batch
        self._done = True
        self._stop.set()
        if kind == "err":
            raise payload
        raise StopIteration

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()
