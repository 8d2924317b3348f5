"""Batched data loader with background prefetch, single process.

Port of ``voice100_tpu/data/loader.py:59-375`` with the same batch order
and content as the JAX loader: the epoch's indices are shuffled by a NumPy
generator seeded with ``seed + epoch``, optionally grouped into length
buckets, cut into batches, read and collated; the last batch is padded to
the full batch size by repeating its items (``pad_to_full``), and
:meth:`DataLoader.iter_with_counts` says how many rows are real. Iterating
the loader reads and collates on a background thread, ``prefetch`` batches
ahead.

One process (``process_index`` 0 of 1). The spawned worker pool
(``num_workers > 0``) waits for the data shell of the port (``ROADMAP.md``
queue 1, item 13) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from .collate import bucket_extent

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2,
                 pad_to_full: bool = True, num_workers: int = 0,
                 length_hint: Optional[Callable[[int], Optional[int]]] = None) -> None:
        if num_workers > 0:
            raise NotImplementedError("the loader's worker pool (num_workers > 0) is not ported "
                                      "yet; it waits for the data shell (ROADMAP.md queue 1, "
                                      "item 13)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        # repeat items to fill the last batch: every batch has one shape
        self.pad_to_full = pad_to_full
        # ``length_hint(i)`` gives an item's frame count cheaply (None when
        # unknown); with it, batches form within collate time buckets
        self.length_hint = length_hint
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_index_chunks(self):
        order = np.arange(len(self.dataset))
        rng = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        if self.length_hint is not None:
            chunks = self._bucketed_chunks(order, rng)
            if chunks is not None:
                return chunks
        n = len(order)
        stop = n - n % self.batch_size if self.drop_last else n
        return [order[start:start + self.batch_size] for start in range(0, stop, self.batch_size)]

    def _bucketed_chunks(self, order, rng):
        """Group the epoch's items by collate time bucket and batch within
        groups; the groups' remainders merge into tail batches, so the
        epoch has as many batches as without buckets. Group order is
        reshuffled each epoch; batches of one bucket stay adjacent. None
        when any item's length is unknown (a cold feature cache)."""
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
        bs = self.batch_size
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

    def _batches(self, with_counts: bool = False) -> Iterator:
        for idx in self._epoch_index_chunks():
            items = [self.dataset[int(i)] for i in idx]
            n_real = len(items)
            if self.pad_to_full and len(items) < self.batch_size:
                reps = -(-self.batch_size // len(items))
                items = (items * reps)[:self.batch_size]
            batch = self.collate_fn(items)
            yield (batch, n_real) if with_counts else batch

    def iter_with_counts(self) -> Iterator:
        """Yield ``(batch, n_real)``: the first ``n_real`` rows are real
        samples, the rest repeat them to fill the batch."""
        yield from self._batches(with_counts=True)

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
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

        thread = threading.Thread(target=producer, daemon=True)
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
