"""Device prefetch: a batch's upload overlaps the steps of the ones before.

Port of ``voice100_tpu/data/prefetch.py``. :class:`DevicePrefetcher`
iterates a loader on a background thread and applies ``place`` (default:
:func:`voice100_tpu_torch.data.pack.device_put_packed` to ``device``) to
each batch, ``size`` batches in flight. An exception of the thread (the
loader's or ``place``'s) is raised at the consumer's ``next``;
:meth:`DevicePrefetcher.close` is safe mid-iteration and closes the
loader's iterator, ending its own threads.

On CUDA, ``place`` runs on a side stream of the prefetcher and records an
event after each batch. The consumer makes its current stream wait for
that event before it takes the batch, and marks each of the batch's
device tensors as used by that stream (``record_stream``), so the caching
allocator cannot hand their memory to the side stream while the
consumer's kernels still read it. On the CPU ``place`` runs on the thread
as it is.

Under a trace of the consumer's thread (:mod:`voice100_tpu_torch.utils.profiling`)
``next`` is the span ``prefetch.wait``, and each batch taken charges
``prefetch.prepare``: the thread's seconds reading it from the loader
and applying ``place``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch

from ..device import resolve_device
from ..utils.profiling import charge, span
from .pack import device_put_packed, tree_flatten

__all__ = ["DevicePrefetcher", "prefetch_to_device"]


class DevicePrefetcher:
    """Iterate ``loader`` with ``place`` applied on a background thread,
    ``size`` batches ahead, for ``device`` (default ``cuda``)."""

    _DONE = object()

    def __init__(self, loader: Iterable[Any], size: int = 2,
                 place: Optional[Callable[[Any], Any]] = None, device=None) -> None:
        if size < 1:
            raise ValueError(f"size must be at least 1, got {size}")
        self.device = resolve_device(device)
        self._place = place if place is not None else (
            lambda batch: device_put_packed(batch, self.device))
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._closed = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(iter(loader),),
                                        name="voice100-device-prefetch", daemon=True)
        self._thread.start()

    def _placed(self, item):
        """``(placed batch, event)``; the event marks the end of its
        device work on the side stream (None on the CPU)."""
        if self._stream is None:
            return self._place(item), None
        with torch.cuda.stream(self._stream):
            placed = self._place(item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it) -> None:
        try:
            while True:
                # timed on every batch: this thread is never traced, and the
                # consumer charges the time to its own session
                start = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                placed, event = self._placed(item)
                if not self._put((placed, event, time.perf_counter() - start)):
                    return
        except BaseException as exc:  # raised again at the consumer's next()
            self._exc = exc
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # a loader generator's own threads end with it
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        with span("prefetch.wait"):
            return self._next()

    def _next(self):
        if self._closed.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            self.close()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        placed, event, prepare_s = item
        charge("prefetch.prepare", prepare_s)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for leaf in tree_flatten(placed)[0]:
                if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                    leaf.record_stream(stream)
        return placed

    def close(self) -> None:
        """Stop the thread (safe mid-iteration) and wait for it a while: it
        finishes the batch it is reading first."""
        self._closed.set()
        try:  # unblock a thread waiting on a full queue
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def prefetch_to_device(loader, size: int = 2, place=None, device=None) -> DevicePrefetcher:
    """A :class:`DevicePrefetcher` to use as a context manager (closed on
    exit, also when the consumer leaves the loop early)."""
    return DevicePrefetcher(loader, size=size, place=place, device=device)
