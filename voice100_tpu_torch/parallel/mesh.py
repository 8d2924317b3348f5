"""Device meshes, batch shards and the process group of data-parallel runs.

Port of ``voice100_tpu/parallel/mesh.py`` in PyTorch's idiom. The JAX
package runs one SPMD program over a ``('data', 'model')`` mesh and lets
GSPMD insert the collectives. The port runs **one process a device**,
joined by ``torch.distributed``: NCCL on CUDA, gloo on the CPU. Each rank
holds a replica of the model, trains on its contiguous rows of every
global batch (``data/loader.py``, ``process_index`` of
``process_count``) and launches the same kernels as a single process, on
its own rows. Serving takes a :class:`Mesh` of devices inside one
process: the pipelines copy their models onto each device of the
``data`` axis and run each device's contiguous rows there
(``inference.py``).

What makes a rank's step a slice of the global batch's step
(:func:`global_batch`):

* the losses divide by denominators summed over the ranks
  (:func:`global_sum`: row counts, mask sums), so the ranks' losses add
  up to the loss of the global batch, and the gradient all-reduce
  (:func:`all_reduce_gradients`, one flat buffer) is a plain sum;
* a BatchNorm in training mode normalizes by the global batch's
  statistics: its per-channel count, sum and sum of squares are summed
  over the ranks in the forward, with autograd through the collective
  (:func:`global_sum_autograd`), as XLA reduces them over the whole
  array in the JAX package;
* random draws (augmentation noise, dropout masks) are made for the
  global batch's shape from the trainer's seeded generator, which every
  rank holds in the same state, and each rank keeps its own rows
  (:func:`own_rows_of_draw`); the augmentation's row roll reads the next
  rank's first row (:func:`roll_rows`).

Outside :func:`global_batch` (every single-process path) these helpers
return their input: nothing changes.

The JAX package's ``kernel_sharding``, ``kernel_batch_axes`` and
``data_shard_map`` exist because ``pallas_call`` does not partition under
GSPMD, so its kernels need a ``shard_map`` over the ``data`` axis. Here
each rank runs its kernels on its own rows, and they have no
counterpart. ``infer_param_spec`` and ``shard_params`` place parameters
on a ``model`` axis (tensor parallelism): they raise, naming
:data:`TENSOR_PARALLEL_ITEM`.

gloo moves CPU tensors. Where a gloo group's tensors lie on a card (two
ranks sharing one GPU, which NCCL refuses), :func:`all_reduce_through_host_`
copies them through pinned host memory and back: that is how gloo moves
the data, while the kernels still run on the card.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "TENSOR_PARALLEL_ITEM", "Mesh", "make_mesh", "fit_mesh_for_batch", "pad_batch_to_multiple",
    "shard_batch", "replicate", "mesh_spans_processes", "init_distributed",
    "shutdown_distributed", "process_index", "process_count", "in_process_group", "barrier",
    "global_batch", "global_batch_active", "global_sum", "global_sum_autograd",
    "own_rows_of_draw", "roll_rows", "all_reduce_",
    "all_reduce_through_host_", "all_reduce_gradients", "all_gather_digest", "collective_counts",
    "infer_param_spec", "shard_params",
]

TENSOR_PARALLEL_ITEM = "ROADMAP.md §1, item 4: tensor-parallel meshes"

log = logging.getLogger(__name__)

# calls of each collective since the last reset (chip_smoke.py reads them)
collective_counts = {"all_reduce_gradients": 0, "global_sum": 0, "global_sum_autograd": 0,
                     "all_reduce": 0, "roll_rows": 0, "all_gather_digest": 0}


def _tensor_parallel(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is tensor-parallel, not ported yet ({TENSOR_PARALLEL_ITEM})")


class Mesh:
    """Devices in a ``(data, model)`` array, as ``jax.sharding.Mesh``
    holds them: ``shape`` is ``{"data": d, "model": m}``."""

    axis_names = ("data", "model")

    def __init__(self, devices: Sequence, data: int, model: int = 1) -> None:
        arr = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            arr[i] = torch.device(d)
        self.devices = arr.reshape(data, model)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices of the ``data`` axis, in order."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _default_devices() -> List[torch.device]:
    """Every CUDA device of this process (``jax.devices()``); raises
    without CUDA, as every entry point of the port does."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every CUDA
    device). ``model > 1`` is tensor parallelism and raises."""
    if model != 1:
        raise _tensor_parallel(f"a mesh with model={model}")
    devices = list(devices) if devices is not None else _default_devices()
    n = len(devices)
    if data is None:
        data = n
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} devices, got {n}")
    return Mesh(devices, data, model)


def fit_mesh_for_batch(batch_size: int, model: int = 1,
                       devices: Optional[Sequence] = None) -> Mesh:
    """The mesh that minimises rows a device over ``batch_size``, with
    the JAX package's policy and warnings (``mesh.py:67-111``): among the
    ``data`` sizes that reach the fewest rows a device, the largest
    divisor of ``batch_size`` (no padding), else the smallest (least
    padding; :func:`pad_batch_to_multiple` pads). Devices left out could
    not reduce the rows a device."""
    if model != 1:
        raise _tensor_parallel(f"a mesh with model={model}")
    devices = list(devices) if devices is not None else _default_devices()
    n = len(devices)
    avail = max(1, n // model)
    min_rows = -(-batch_size // avail)
    candidates = [d for d in range(1, avail + 1) if -(-batch_size // d) == min_rows]
    divisors = [d for d in candidates if batch_size % d == 0]
    data = max(divisors) if divisors else min(candidates)
    used = data * model
    if batch_size % data != 0:
        log.warning(
            "fit_mesh_for_batch: batch_size=%d is not divisible by the "
            "%dx%d mesh; each batch is padded to %d by replicating "
            "trailing samples (duplicates carry normal loss weight — "
            "equivalent to drawing them twice). Pick a batch size "
            "divisible by %d devices to avoid the padding.",
            batch_size, data, model, min_rows * data, data,
        )
    elif used < n:
        log.warning(
            "fit_mesh_for_batch: using a %dx%d mesh and leaving %d "
            "device(s) idle — with batch_size=%d the idle devices "
            "could not reduce the %d rows each device already "
            "processes, so this layout is wall-clock optimal.",
            data, model, n - used, batch_size, min_rows,
        )
    return make_mesh(devices[:used], data=data, model=model)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _tree_map(fn, tree):
    """``fn`` of every leaf of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, child) for child in tree)
    if isinstance(tree, dict):
        return {key: _tree_map(fn, child) for key, child in tree.items()}
    return fn(tree)


def pad_batch_to_multiple(batch, multiple: int):
    """Pad every leaf's leading (batch) axis up to a multiple of
    ``multiple`` by wrap-around repeats of its rows, the loader's
    ``pad_to_full`` convention. Leaves are NumPy arrays or tensors in
    nested tuples, lists or dicts. Returns ``(batch, n_real)``; a batch
    that divides already comes back as it is."""
    leaves = _leaves(batch)
    if not leaves:
        return batch, 0
    n_real = leaves[0].shape[0]
    target = -(-n_real // multiple) * multiple
    if target == n_real:
        return batch, n_real
    idx = np.arange(target) % n_real
    return _tree_map(lambda leaf: leaf[torch.from_numpy(idx).to(leaf.device)]
                     if isinstance(leaf, torch.Tensor) else np.asarray(leaf)[idx], batch), n_real


def shard_batch(batch, mesh: Mesh) -> list:
    """A batch's leading axis split into ``mesh``'s ``data`` devices'
    contiguous shards, each moved to its device: one batch a device, in
    device order. The rows must divide evenly (:func:`pad_batch_to_multiple`)."""
    devices = mesh.data_devices
    n = _leaves(batch)[0].shape[0]
    if n % len(devices):
        raise ValueError(f"{n} rows do not split over the mesh data axis {len(devices)}")
    rows = n // len(devices)
    return [_tree_map(lambda leaf: torch.as_tensor(leaf[i * rows:(i + 1) * rows]).to(dev), batch)
            for i, dev in enumerate(devices)]


def replicate(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One copy of ``module`` a device of ``mesh``'s ``data`` axis, in
    order (the JAX package's replicated parameters): the module itself on
    the first device, a copy on each other device (one a device, reused
    where the axis names a device twice)."""
    devices = mesh.data_devices
    by_device = {devices[0]: module.to(devices[0])}
    for dev in devices[1:]:
        if dev not in by_device:
            by_device[dev] = copy.deepcopy(module).to(dev)
    return [by_device[dev] for dev in devices]


# -- the process group --------------------------------------------------------

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     device=None, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group (``jax.distributed.initialize``): with
    ``coordinator_address`` (``host:port`` of rank 0), ``num_processes``
    and ``process_id``, over ``tcp://``; with none of them, from
    torchrun's environment (``env://``). ``backend`` defaults to NCCL for
    a CUDA ``device`` (default ``cuda``) and gloo for the CPU."""
    if dist.is_initialized():
        raise RuntimeError("the process group is initialized already")
    manual = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in manual) and any(v is None for v in manual):
        raise ValueError("--coordinator_address, --num_processes and --process_id go together "
                         "(or none of them, under torchrun)")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=timeout)


def shutdown_distributed() -> None:
    """Leave the process group, where this process joined one."""
    if in_process_group():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if in_process_group() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if in_process_group() else 1


def in_process_group() -> bool:
    """Whether this process has joined a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def mesh_spans_processes() -> bool:
    """Whether the run spans processes: a world size above 1."""
    return process_count() > 1


def barrier() -> None:
    """Wait for every rank, where there is a process group."""
    if in_process_group():
        dist.barrier()


def _comm_device() -> torch.device:
    """Where the backend's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_through_host_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum a card's ``tensor`` over a gloo group, in place: one copy into
    pinned host memory, the all-reduce there, one copy back."""
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    dist.all_reduce(host)
    tensor.copy_(host, non_blocking=True)
    return tensor


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place: on the card under NCCL,
    in host memory under gloo (a card's tensor through
    :func:`all_reduce_through_host_`)."""
    collective_counts["all_reduce"] += 1
    if tensor.device.type == "cuda" and dist.get_backend() != "nccl":
        return all_reduce_through_host_(tensor)
    dist.all_reduce(tensor)
    return tensor


def all_reduce_gradients(params) -> None:
    """Sum every parameter's gradient over the ranks: one all-reduce of
    one flat buffer, copied back into the gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    collective_counts["all_reduce_gradients"] += 1
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_gather_digest(value: int) -> List[int]:
    """Every rank's ``value`` (a small integer), in rank order."""
    collective_counts["all_gather_digest"] += 1
    t = torch.tensor([value], dtype=torch.int64, device=_comm_device())
    out = [torch.zeros_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [int(x) for x in out]


# -- a rank's batch as rows of the global batch -------------------------------

_GLOBAL_BATCH: Optional[tuple] = None  # (rank, world) inside global_batch()


@contextlib.contextmanager
def global_batch(enabled: bool = True):
    """Inside, this rank's batch is its contiguous rows of a global batch
    that every rank of the process group holds a share of, all shares the
    same size: losses take global denominators, draws the global shape.
    Without a process group (or with ``enabled`` False) nothing changes."""
    global _GLOBAL_BATCH
    prev = _GLOBAL_BATCH
    if enabled and in_process_group():
        _GLOBAL_BATCH = (dist.get_rank(), dist.get_world_size())
    try:
        yield
    finally:
        _GLOBAL_BATCH = prev


def global_batch_active() -> bool:
    return _GLOBAL_BATCH is not None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the global batch (a loss's
    denominator: a row count or a mask sum), outside autograd; ``t``
    itself outside :func:`global_batch`."""
    if _GLOBAL_BATCH is None:
        return t
    collective_counts["global_sum"] += 1
    out = t.detach().clone()
    all_reduce_(out)
    return out


class _GlobalSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the ranks' gradients summed:
    every rank's share of the global loss reads the summed value, so the
    global loss's gradient with respect to one rank's addend is the sum of
    every rank's gradient with respect to the total."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone())


def global_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the global batch, differentiable (a
    BatchNorm's per-channel sums); ``t`` itself outside
    :func:`global_batch`."""
    if _GLOBAL_BATCH is None:
        return t
    collective_counts["global_sum_autograd"] += 1
    return _GlobalSum.apply(t)


def own_rows_of_draw(draw, shape) -> torch.Tensor:
    """``draw(shape)``, a random tensor whose leading axis is the batch;
    inside :func:`global_batch` it is drawn for the global batch and this
    rank's rows are kept, so the generator moves as one process's would."""
    if _GLOBAL_BATCH is None:
        return draw(tuple(shape))
    rank, world = _GLOBAL_BATCH
    rows = shape[0]
    return draw((rows * world, *shape[1:]))[rank * rows:(rank + 1) * rows]


def roll_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, -1, 0)`` of the global batch, this rank's rows:
    row i takes row i + 1, the last row the next rank's first (the
    global batch's first row on the last rank)."""
    if _GLOBAL_BATCH is None or _GLOBAL_BATCH[1] == 1:
        return torch.roll(x, shifts=-1, dims=0)
    rank, world = _GLOBAL_BATCH
    collective_counts["roll_rows"] += 1
    first = x[:1].contiguous()
    gathered = [torch.empty_like(first, device=_comm_device()) for _ in range(world)]
    if first.device.type == "cuda" and dist.get_backend() != "nccl":
        host = first.cpu()
        dist.all_gather(gathered, host)
    else:
        dist.all_gather(gathered, first)
    return torch.cat([x[1:], gathered[(rank + 1) % world].to(x.device)])


# -- tensor parallelism -------------------------------------------------------

def infer_param_spec(*args, **kwargs):
    """A parameter's placement on a ``model`` axis: tensor-parallel."""
    raise _tensor_parallel("infer_param_spec")


def shard_params(*args, **kwargs):
    """Parameters placed on a ``model`` axis: tensor-parallel."""
    raise _tensor_parallel("shard_params")
