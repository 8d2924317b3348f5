"""Packed host->device batch upload: one copy a batch.

Port of ``voice100_tpu/data/pack.py``. A collated batch (nested tuples,
lists or dicts of NumPy arrays or CPU tensors) has several leaves; each
host->device copy has a fixed cost, so :func:`device_put_packed` packs the
leaves into one ``uint8`` buffer (pinned on CUDA), copies it to the device
in one ``copy_`` and unpacks it there as ``view(dtype)`` slices of the one
device buffer, with no device work at all.

``Tensor.view(dtype)`` needs a slice's byte offset to be a multiple of the
element size (JAX's bitcast does not), so every leaf starts at a multiple
of :data:`ALIGN` bytes.

Only float32, float16, bfloat16, int32 and uint32 leaves pack, the JAX
package's set (``pack.py:35-47``): a batch with any other leaf uploads
leaf by leaf (``pack.py:115-130``). bfloat16 leaves may be CPU tensors
(the trainer's bf16 upload cast) or ``ml_dtypes`` arrays.

On CUDA the copy is ``non_blocking`` from pinned memory on the current
stream (the prefetcher's side stream, ``data/prefetch.py``). PyTorch's
caching host allocator records that stream's use of the pinned block, so
the block is not handed out again before the copy has completed.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["pack_batch", "unpack_batch", "device_put_packed", "tree_flatten", "tree_unflatten",
           "host_tensor", "ALIGN"]

ALIGN = 16  # bytes: every leaf's offset in the packed buffer is a multiple of it

_PACK_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.int32, torch.uint32)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` of nested tuples, lists and dicts (dict keys
    in sorted order, as ``jax.tree_util`` flattens them); anything else is
    a leaf."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, (tuple, list)):
            return (type(node), tuple(walk(child) for child in node))
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, tuple(keys), tuple(walk(node[k]) for k in keys))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        if node[0] is dict:
            return {k: build(child) for k, child in zip(node[1], node[2])}
        return node[0](build(child) for child in node[1])

    return build(treedef)


def host_tensor(leaf) -> torch.Tensor:
    """A batch leaf as a tensor: a tensor as it is, an array (``ml_dtypes``
    bfloat16 included) as a CPU tensor sharing its memory where it can."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.ascontiguousarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def pack_batch(batch, pin: bool = False):
    """``(uint8 CPU buffer, spec)`` of a batch, or ``(None, None)`` when a
    leaf's dtype does not pack (or a leaf is not on the CPU); ``pin``
    allocates the buffer in pinned memory."""
    leaves, treedef = tree_flatten(batch)
    tensors = [host_tensor(leaf) for leaf in leaves]
    if not all(t.dtype in _PACK_DTYPES and t.device.type == "cpu" for t in tensors):
        return None, None
    offsets, total = [], 0
    for t in tensors:
        total = _aligned(total)
        offsets.append(total)
        total += t.numel() * t.element_size()
    packed = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    for t, off in zip(tensors, offsets):
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        packed[off:off + raw.numel()].copy_(raw)
    spec = (treedef, tuple((tuple(t.shape), t.dtype, off) for t, off in zip(tensors, offsets)))
    return packed, spec


def unpack_batch(packed: torch.Tensor, spec):
    """The batch of a packed buffer (on any device) as views of it."""
    treedef, leaf_specs = spec
    leaves = []
    for shape, dtype, off in leaf_specs:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        leaves.append(packed[off:off + n].view(dtype).view(shape))
    return tree_unflatten(treedef, leaves)


def device_put_packed(batch, device):
    """The batch on ``device`` in one copy (leaf by leaf when a leaf's
    dtype does not pack). On CUDA the copy is enqueued on the current
    stream from pinned memory and does not block the host."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    packed, spec = pack_batch(batch, pin=on_cuda)
    if packed is None:
        leaves, treedef = tree_flatten(batch)
        return tree_unflatten(treedef, [host_tensor(leaf).to(device, non_blocking=on_cuda)
                                        for leaf in leaves])
    return unpack_batch(packed.to(device, non_blocking=on_cuda), spec)
