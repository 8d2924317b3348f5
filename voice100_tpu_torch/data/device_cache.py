"""Device-resident feature cache: epochs assembled on the card.

Port of ``voice100_tpu/data/device_cache.py`` for one device. Each clip's
collated rows upload once; every later epoch assembles its shuffled
batches by a gather on the device, so only the batches' row indices cross
the host->device link (``training/trainer.py`` ``device_cache``).

The store is one tensor a leaf of the collated batch, ``[n_items, *row]``,
on the cache's device (the model's), filled with the collate's pad value
of that leaf (``pad_values``, which the collates of ``data/collate.py``
carry). Collated batches come in buckets of different extents, so the
store keeps each row at the largest extent seen so far, grows when a
batch needs more (checking ``max_bytes`` before it allocates), and
slices gathers down to the batch's bucket: a row's true length never
exceeds a bucket it appears under, so a gathered batch equals the host's
collation of the same items byte for byte. Without ``pad_values`` every
batch must have the store's extents.

:meth:`DeviceFeatureCache.place` returns a batch on the device: uploaded
(one packed copy) and scattered into the store while any of its rows is
not cached yet, gathered from the store once all are. Rows that
``pad_to_full`` repeats repeat their index and write the same content.
Epochs that miss clips (``drop_last``) upload them whenever they first
appear.

With ``var_specs`` (the collates' feature leaf -> (length leaf, bucket
kind)) the cache records each row's true lengths, and
:meth:`DeviceFeatureCache.epoch_plan` groups an epoch's batches into
maximal runs of consecutive batches of one collate bucket: the
multi-step dispatch of the trainer (``steps_per_dispatch``) runs each
group's steps at the group's extents through :meth:`gather_rows`.

``mesh`` takes a :class:`voice100_tpu_torch.parallel.Mesh` of one
device, which places the store there, as ``device`` does. A mesh of more
devices raises: the JAX package shards the store over a one-process
mesh, while the port trains over several devices one process a device
(``--distributed``), where the trainer turns the cache off, as the JAX
multi-process trainer does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import Mesh
from .collate import bucket_extent
from .pack import device_put_packed, host_tensor, tree_flatten, tree_unflatten

__all__ = ["DeviceFeatureCache"]


def _rows(extents) -> tuple:
    """The index of a leaf's rows cut to ``extents`` (after the item axis)."""
    return tuple(slice(0, d) for d in extents)


class DeviceFeatureCache:
    """Device-resident rows of a loader's dataset, on ``device`` (default
    ``cuda``)."""

    def __init__(self, n_items: int, max_bytes: Optional[int] = None, pad_values=None,
                 mesh=None, var_specs=None, device=None) -> None:
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a voice100_tpu_torch.parallel.Mesh, got "
                                f"{type(mesh).__name__}")
            if mesh.size > 1:
                raise NotImplementedError(
                    f"a device cache over a mesh of {mesh.size} devices: the port trains over "
                    f"several devices one process a device (--distributed), where the cache is "
                    f"off, as in the JAX multi-process trainer")
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.n_items = int(n_items)
        self.max_bytes = max_bytes
        self._var_specs = dict(var_specs) if var_specs else None
        self._lengths = None
        if self._var_specs:
            self._spec_cols = {li: col for col, li in enumerate(sorted(self._var_specs))}
            self._lengths = np.zeros((self.n_items, len(self._spec_cols)), np.int64)
        self._leaves = None        # the store, one tensor a leaf
        self._treedef = None
        self._shapes = None        # each leaf's (row shape, dtype)
        self._cached = np.zeros(self.n_items, bool)
        self._pad_leaves = None if pad_values is None else tree_flatten(pad_values)[0]

    @property
    def complete(self) -> bool:
        return bool(self._cached.all())

    @property
    def store(self):
        """The store in the batch's structure (None before the first place)."""
        return None if self._leaves is None else tree_unflatten(self._treedef, self._leaves)

    def nbytes(self) -> int:
        return 0 if self._leaves is None else sum(s.numel() * s.element_size()
                                                  for s in self._leaves)

    def _check_budget(self, shapes) -> None:
        total = sum(int(np.prod((self.n_items,) + shape)) * dtype.itemsize
                    for shape, dtype in shapes)
        if self.max_bytes is not None and total > self.max_bytes:
            raise ValueError(f"device feature cache would need {total / 1e9:.2f} GB > "
                             f"max_bytes={self.max_bytes / 1e9:.2f} GB; use the streaming "
                             "loader for corpora that exceed device memory")

    def _init_store(self, batch) -> None:
        leaves, self._treedef = tree_flatten(batch)
        tensors = [host_tensor(leaf) for leaf in leaves]
        self._shapes = [(tuple(t.shape[1:]), t.dtype) for t in tensors]
        self._check_budget(self._shapes)
        if self._pad_leaves is None:
            pads = [0] * len(leaves)
        elif len(self._pad_leaves) != len(leaves):
            raise ValueError(f"pad_values has {len(self._pad_leaves)} leaves, batch has "
                             f"{len(leaves)}")
        else:
            pads = self._pad_leaves
        self._leaves = [torch.full((self.n_items,) + shape, pad, dtype=dtype, device=self.device)
                        for (shape, dtype), pad in zip(self._shapes, pads)]

    def _batch_shapes(self, batch):
        leaves = [host_tensor(leaf) for leaf in tree_flatten(batch)[0]]
        if len(leaves) != len(self._shapes):
            raise ValueError(f"batch has {len(leaves)} leaves, store has {len(self._shapes)}")
        out = []
        for leaf, (shape, dtype) in zip(leaves, self._shapes):
            got = tuple(leaf.shape[1:])
            if leaf.dtype != dtype or len(got) != len(shape):
                raise ValueError(f"device feature cache row layout drifted (stored rows "
                                 f"{shape}/{dtype}, got {got}/{leaf.dtype})")
            out.append(got)
        return out

    def _fit_extents(self, batch) -> None:
        """Grow the store (pad-value fill) to this batch's bucket; without
        pad values a batch must have the store's extents."""
        got = self._batch_shapes(batch)
        if self._pad_leaves is None:
            for g, (shape, dtype) in zip(got, self._shapes):
                if g != shape:
                    raise ValueError(
                        f"device feature cache needs a fixed collate bucket (stored rows "
                        f"{shape}/{dtype}, got {g}/{dtype}) — the collate_fn carries no "
                        "pad_values; set VOICE100_TPU_TIME_BUCKET/VOICE100_TPU_TEXT_BUCKET to "
                        "a single bucket")
            return
        targets = [tuple(max(a, b) for a, b in zip(shape, g))
                   for g, (shape, _) in zip(got, self._shapes)]
        if all(t == shape for t, (shape, _) in zip(targets, self._shapes)):
            return
        new_shapes = [(t, dtype) for t, (_, dtype) in zip(targets, self._shapes)]
        self._check_budget(new_shapes)
        grown = []
        for s, target, (shape, dtype), pad in zip(self._leaves, targets, self._shapes,
                                                  self._pad_leaves):
            if target != shape:
                bigger = torch.full((self.n_items,) + target, pad, dtype=dtype,
                                    device=self.device)
                bigger[(slice(None),) + _rows(shape)] = s
                s = bigger
            grown.append(s)
        self._leaves, self._shapes = grown, new_shapes

    def _track_lengths(self, idx, batch) -> None:
        """Each row's true lengths, from the batch's length leaves (collate
        never buckets those), for :meth:`epoch_plan`."""
        if self._var_specs is None:
            return
        leaves = tree_flatten(batch)[0]
        for li, (len_leaf, _kind) in self._var_specs.items():
            lengths = host_tensor(leaves[len_leaf]).cpu().numpy()
            self._lengths[idx, self._spec_cols[li]] = lengths[:len(idx)]

    def place(self, indices, batch):
        """``batch`` on the device; caches its rows as a side effect."""
        idx = np.asarray(indices, np.int64)
        if self._leaves is None:
            self._init_store(batch)
        self._fit_extents(batch)
        self._track_lengths(idx, batch)
        idx_dev = torch.from_numpy(idx).to(self.device, non_blocking=True)
        if self._cached[idx].all():
            shapes = self._batch_shapes(batch)
            return tree_unflatten(self._treedef, [s[(idx_dev,) + _rows(shape)]
                                                  for s, shape in zip(self._leaves, shapes)])
        placed = device_put_packed(batch, self.device)
        for s, rows in zip(self._leaves, tree_flatten(placed)[0]):
            s[(idx_dev,) + _rows(rows.shape[1:])] = rows
        self._cached[idx] = True
        return placed

    def epoch_batches(self, loader):
        """One epoch of device-resident batches."""
        for indices, batch in loader.iter_with_indices():
            yield self.place(indices, batch)

    def gather_rows(self, store, idx, extents=None):
        """The batch of rows ``idx`` (a tensor on the device, or an array),
        each leaf cut to ``extents`` (a group's extents from
        :meth:`epoch_plan`; the store's full extents without them). Rows
        past their true extent hold the pad value and lengths are stored
        rows, so the batch equals the host's collation at those extents."""
        idx = torch.as_tensor(idx).to(self.device, non_blocking=True)
        leaves = tree_flatten(store)[0]
        if extents is None:
            out = [s[idx] for s in leaves]
        else:
            out = [s[(idx,) + _rows(shape)] for s, shape in zip(leaves, extents)]
        return tree_unflatten(self._treedef, out)

    def epoch_plan(self, loader):
        """The epoch's batches grouped by collate bucket: a list of
        ``(extents, idx_mat)``, ``extents`` the row shape of each leaf that
        host collation would give every batch of the group and ``idx_mat``
        its ``[k, B]`` row indices. Groups are maximal runs of consecutive
        batches of one bucket, so the epoch's batch order is kept. One
        full-extent group when the collate has no ``var_specs``; None
        under :meth:`epoch_index_matrix`'s conditions."""
        mat = self.epoch_index_matrix(loader)
        if mat is None:
            return None
        if self._var_specs is None:
            return [(tuple(s for s, _ in self._shapes), mat)]
        runs = []
        cur_key, cur_rows = None, []
        for row in mat:
            extents = []
            for li, (shape, _dtype) in enumerate(self._shapes):
                spec = self._var_specs.get(li)
                if spec is None:
                    extents.append(shape)
                    continue
                n = int(self._lengths[row, self._spec_cols[li]].max())
                # a bucket granularity that grew since the store filled can
                # put the bucket past the store's extent
                extents.append((min(bucket_extent(spec[1], n), shape[0]),) + shape[1:])
            key = tuple(extents)
            if key != cur_key:
                if cur_rows:
                    runs.append((cur_key, np.stack(cur_rows)))
                cur_key, cur_rows = key, []
            cur_rows.append(row)
        if cur_rows:
            runs.append((cur_key, np.stack(cur_rows)))
        return runs

    def epoch_index_matrix(self, loader):
        """The epoch's batches (after ``loader.set_epoch``) as a
        ``[n_batches, B]`` int64 row-index matrix, or None when the epoch
        cannot be gathered on the device alone: the store absent or not
        complete (the warm epoch goes through :meth:`place`), or batches
        of unequal rows (no ``pad_to_full`` and a short last batch)."""
        if self._leaves is None or not self.complete:
            return None
        chunks = loader._epoch_index_chunks()
        if not chunks:
            return None
        rows = [loader._effective_indices(idx) for idx in chunks]
        if any(len(r) != len(rows[0]) for r in rows[1:]):
            return None
        return np.stack(rows).astype(np.int64)
