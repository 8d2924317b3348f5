"""Batched data loader: a background thread or a pool of worker processes.

Port of ``voice100_tpu/data/loader.py`` with the same batch order and
content as the JAX loader: the epoch's indices are shuffled by a NumPy
generator seeded with ``seed + epoch``, optionally grouped into length
buckets, cut into batches, read and collated; the last batch is padded to
the full batch size by repeating its items (``pad_to_full``), and
:meth:`DataLoader.iter_with_counts` says how many rows are real.
:meth:`DataLoader.iter_with_indices` gives each batch beside its rows'
dataset indices, pad repeats included (the device feature cache,
``data/device_cache.py``, keys its rows by them). Before it reads a
batch's items the loader hands their indices to the dataset's
``prefetch`` where it has one (the native batch decode of
:class:`voice100_tpu_torch.data.transforms.EncodedCacheDataset`).

``num_workers=0`` (the default) reads and collates on a background
thread, ``prefetch`` batches ahead. ``num_workers > 0`` reads and collates
each batch in a spawned worker process (``ProcessPoolExecutor``, kept
across epochs; :meth:`DataLoader.close` ends it and waits for its
processes) with at most
``num_workers + max(prefetch, 1)`` batches in flight and no thread between
the pool and the consumer. Either way the batches are the same, in the
same order.

The workers run on the host CPU only, as the JAX package's do
(``voice100_tpu/data/loader.py:33-43``): each worker's initializer sets
one torch thread and moves the dataset's audio transform to the CPU
(``to_host``), so a feature-cache miss in a worker computes the plain
PyTorch log-mel and never opens a CUDA context beside the trainer's.
That is the design, not a fallback: the log-mel kernel runs on the card
for cache misses read at ``num_workers=0``. The WORLD analysis is host
float64 code on either path.

``process_index`` of ``process_count`` reads one process's share of a
multi-process epoch (``loader.py:150-192``): every process forms the same
global batches of ``batch_size * process_count`` rows and takes its
contiguous slice of each; a short last global batch is strided over the
processes, each padding its rows (``pad_to_full``), so every process
gives the same number of batches.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np

from .collate import bucket_extent

__all__ = ["DataLoader", "PREFETCH_THREAD"]

PREFETCH_THREAD = "voice100-loader-prefetch"  # the name of the producer thread

# -- the worker processes' state (module level, so that "spawn" can pickle) --
_WORKER_STATE: Optional[tuple] = None


def _worker_init(state_queue) -> None:
    """Runs once in each spawned worker: one torch thread, the loader's
    state from ``state_queue``, the dataset's audio transform on the CPU."""
    import torch

    global _WORKER_STATE
    torch.set_num_threads(1)
    dataset, collate_fn, pad_to_full, batch_size = state_queue.get()
    transform = getattr(dataset, "audio_transform", None)
    if transform is not None and hasattr(transform, "to_host"):
        transform.to_host()
    _WORKER_STATE = (dataset, collate_fn, pad_to_full, batch_size)


def _read_batch(dataset, collate_fn, pad_to_full, batch_size, idx):
    """``(collated batch, n_real)`` of the items ``idx``: the dataset's
    batch prefetch first, the pad repeats after the real rows."""
    batch_prefetch = getattr(dataset, "prefetch", None)
    if callable(batch_prefetch):
        # native thread-pool decode of the batch's cache misses
        batch_prefetch(idx)
    items = [dataset[int(i)] for i in idx]
    n_real = len(items)
    if pad_to_full and len(items) < batch_size:
        reps = -(-batch_size // len(items))
        items = (items * reps)[:batch_size]
    return collate_fn(items), n_real


def _worker_collate(idx):
    return _read_batch(*_WORKER_STATE, idx)


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2,
                 pad_to_full: bool = True, process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0,
                 length_hint: Optional[Callable[[int], Optional[int]]] = None) -> None:
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        # repeat items to fill the last batch: every batch has one shape
        self.pad_to_full = pad_to_full
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        # ``length_hint(i)`` gives an item's frame count cheaply (None when
        # unknown); with it, batches form within collate time buckets
        self.length_hint = length_hint
        self._executor = None
        self._state_queue = None
        self._epoch = 0

    def _get_executor(self):
        """The worker pool, started at first use and kept across epochs
        (a spawned worker takes seconds to start)."""
        if self._executor is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context("spawn")
            # each worker takes the dataset from a queue once it has started:
            # as an initializer argument it would be written into each new
            # process's pipe, and one past the pipe's buffer (a WORLD
            # dataset's matrices) blocks the parent until that process has
            # imported its modules, so the workers would start one by one
            self._state_queue = ctx.Queue()
            for _ in range(self.num_workers):
                self._state_queue.put((self.dataset, self.collate_fn, self.pad_to_full,
                                       self.batch_size))
            self._executor = ProcessPoolExecutor(max_workers=self.num_workers, mp_context=ctx,
                                                 initializer=_worker_init,
                                                 initargs=(self._state_queue,))
        return self._executor

    def close(self) -> None:
        """Shut the worker pool down and wait for its processes to end (a
        worker still starting ends once it has its state); a later epoch
        starts a new pool."""
        self._shutdown(wait=True)

    def __del__(self) -> None:
        try:
            self._shutdown(wait=False)
        except Exception:  # interpreter teardown: nothing left to release
            pass

    def _shutdown(self, wait: bool) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=wait, cancel_futures=True)
            self._executor = None
            # copies that no worker took (the pool starts workers as its
            # tasks need them) are dropped with the queue
            self._state_queue.cancel_join_thread()
            self._state_queue.close()
            self._state_queue = None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        # one local batch a global batch: every process has the same count
        n, gbs = len(self.dataset), self.batch_size * self.process_count
        return n // gbs if self.drop_last else -(-n // gbs)

    def _epoch_index_chunks(self):
        order = np.arange(len(self.dataset))
        rng = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        gbs = self.batch_size * self.process_count
        chunks = None
        if self.length_hint is not None:
            chunks = self._bucketed_chunks(order, rng, gbs)
        if chunks is None:
            chunks = self._plain_chunks(order, gbs)
        if self.process_count <= 1:
            return chunks
        # this process's contiguous rows of each global batch; the short
        # last one strides its rows over the processes
        p, pc, bs = self.process_index, self.process_count, self.batch_size
        out = []
        for chunk in chunks:
            if len(chunk) == gbs:
                out.append(chunk[p * bs:(p + 1) * bs])
            else:
                rows = chunk[p::pc]
                if len(rows) == 0:
                    # fewer tail rows than processes: repeat one, so that
                    # every process gives the same number of batches
                    rows = chunk[p % len(chunk):p % len(chunk) + 1]
                out.append(rows)
        return out

    def _plain_chunks(self, order, batch_size):
        n = len(order)
        stop = n - n % batch_size if self.drop_last else n
        return [order[start:start + batch_size] for start in range(0, stop, batch_size)]

    def _bucketed_chunks(self, order, rng, batch_size=None):
        """Group the epoch's items by collate time bucket and batch within
        groups of ``batch_size`` (default the loader's); the groups'
        remainders merge into tail batches, so the epoch has as many
        batches as without buckets. Group order is reshuffled each epoch;
        batches of one bucket stay adjacent. None when any item's length is
        unknown (a cold feature cache)."""
        groups, keys = {}, []
        for i in order:
            n = self.length_hint(int(i))
            if n is None:
                return None
            b = bucket_extent("time", int(n))
            if b not in groups:
                groups[b] = []
                keys.append(b)
            groups[b].append(i)
        if rng is not None:
            keys = [keys[j] for j in rng.permutation(len(keys))]
        bs = batch_size or self.batch_size
        chunks, leftover = [], []
        for b in keys:
            idxs = np.asarray(groups[b])
            full = len(idxs) - len(idxs) % bs
            chunks.extend(idxs[s:s + bs] for s in range(0, full, bs))
            leftover.extend(idxs[full:])
        leftover = np.asarray(leftover, dtype=order.dtype)
        stop = len(leftover) - len(leftover) % bs if self.drop_last else len(leftover)
        chunks.extend(leftover[s:s + bs] for s in range(0, stop, bs))
        return chunks

    def _effective_indices(self, idx) -> np.ndarray:
        """The dataset index of each row of a collated batch, the pad
        repeats included (as ``_read_batch`` repeats the items)."""
        if self.pad_to_full and len(idx) < self.batch_size:
            reps = -(-self.batch_size // len(idx))
            return np.concatenate([idx] * reps)[:self.batch_size]
        return np.asarray(idx)

    def _batches(self, with_counts: bool = False, with_indices: bool = False) -> Iterator:
        chunks = self._epoch_index_chunks()
        read = self._read_pooled(chunks) if self.num_workers > 0 else (
            _read_batch(self.dataset, self.collate_fn, self.pad_to_full, self.batch_size, idx)
            for idx in chunks)
        try:
            for idx, (batch, n_real) in zip(chunks, read):
                out = (batch, n_real) if with_counts else batch
                yield (self._effective_indices(idx), out) if with_indices else out
        finally:
            read.close()  # cancels the pool's batches still in flight

    def _read_pooled(self, chunks) -> Iterator:
        """``(batch, n_real)`` of each chunk, read and collated in the
        worker processes, in order, with a bounded window of batches in
        flight (a worker's exception is raised here, at its batch)."""
        executor = self._get_executor()
        window = self.num_workers + max(self.prefetch, 1)
        pending: deque = deque()
        submitted = 0
        try:
            while pending or submitted < len(chunks):
                while submitted < len(chunks) and len(pending) < window:
                    pending.append(executor.submit(_worker_collate, chunks[submitted]))
                    submitted += 1
                yield pending.popleft().result()
        finally:
            for future in pending:
                future.cancel()

    def iter_with_counts(self) -> Iterator:
        """Yield ``(batch, n_real)``: the first ``n_real`` rows are real
        samples, the rest repeat them to fill the batch."""
        yield from self._batches(with_counts=True)

    def iter_with_indices(self) -> Iterator:
        """Yield ``(indices, batch)``: ``indices[i]`` is the dataset index
        of row ``i`` (a pad repeat repeats its source's index)."""
        yield from self._batches(with_indices=True)

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0 or self.num_workers > 0:
            # the pool overlaps through its window of futures; a thread
            # between it and the consumer would only add a queue
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # gives up when the consumer is gone, so an abandoned iterator
            # cannot leave this thread blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
            except BaseException as e:  # handed to the consumer
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, name=PREFETCH_THREAD, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is sentinel:
                    break
                yield batch
            thread.join()
        finally:
            stop.set()
            thread.join(timeout=5.0)
        if error:
            raise error[0]
