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
counterpart.

Tensor parallelism (a ``model`` axis of size m > 1) is the JAX kernel
path (``kernel_batch_axes``: the batch split over ``data x model``, the
weights all-gathered once a step, every device running the kernels on
its rows) written over ranks. The world of ``data * model`` ranks shares
each global batch as a data-parallel world of that size does; rank r has
data index ``r // m`` and model index ``r % m`` (:func:`make_mesh`'s
``reshape(data, model)`` of the rank order). :func:`infer_param_spec`
picks the axis of a parameter to shard, :func:`shard_params` cuts it into
m contiguous chunks (model index k keeps chunk k), and
:class:`ParamShards` keeps a rank's chunks as the tensors its optimizer
steps: between steps the module's sharded tensors are released, and each
step rebuilds them in one flat all-gather within the rank's model group
(:func:`all_gather_params`). The gradient is summed over all ranks as in
data parallelism, clipped whole, and each rank's Adam steps its slices of
it, so its moments exist only for the shards.

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
    "Mesh", "make_mesh", "fit_mesh_for_batch", "pad_batch_to_multiple",
    "shard_batch", "replicate", "mesh_spans_processes", "init_distributed",
    "shutdown_distributed", "process_index", "process_count", "in_process_group", "barrier",
    "global_batch", "global_batch_active", "global_sum", "global_sum_autograd",
    "own_rows_of_draw", "roll_rows", "all_reduce_",
    "all_reduce_through_host_", "all_reduce_gradients", "all_gather_digest", "collective_counts",
    "infer_param_spec", "shard_params", "process_mesh", "model_group", "all_gather_params",
    "ParamShards",
]

log = logging.getLogger(__name__)

# calls of each collective since the last reset (chip_smoke.py reads them)
collective_counts = {"all_reduce_gradients": 0, "global_sum": 0, "global_sum_autograd": 0,
                     "all_reduce": 0, "roll_rows": 0, "all_gather_digest": 0,
                     "all_gather_params": 0}


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
    device), the devices in row-major order. ``data`` defaults to
    ``len(devices) // model``; a ``model`` that does not divide the
    devices, or a shape that does not hold them all, raises ``ValueError``
    where the JAX function's assertion fails."""
    devices = list(devices) if devices is not None else _default_devices()
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"a mesh with model={model} needs a multiple of {model} devices, "
                             f"got {n}")
        data = n // model
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

def infer_param_spec(leaf, mesh: Mesh, min_size: int = 256) -> tuple:
    """A parameter's placement on ``mesh``'s ``model`` axis, the JAX
    policy (``voice100_tpu/parallel/mesh.py:225-250``): the largest axis
    that divides by the ``model`` size and is at least ``min_size`` long
    is sharded (ties go to the later axis, ``max`` over ``(size, axis)``),
    which catches the LSTM gate matrices, conv and dense kernels and
    biases of ``min_size`` or more; anything else, and everything on a
    mesh whose ``model`` axis is 1, is replicated. Returns the spec as a
    tuple, which compares equal to the JAX ``PartitionSpec``:
    ``("model", None)`` shards the first of two axes, ``()`` replicates.

    ``leaf`` is anything with a ``shape``. The port's tensors have
    PyTorch's layouts (``[out, in, k]``, ``[out, in]``), so the axis picked
    on a port tensor may be another logical axis than on the flax leaf;
    the numbers do not depend on it, since every forward reads the
    all-gathered weights."""
    model_size = mesh.shape["model"]
    shape = tuple(leaf.shape)
    if model_size == 1 or not shape:
        return ()
    candidates = [(size, dim) for dim, size in enumerate(shape)
                  if size % model_size == 0 and size >= min_size]
    if not candidates:
        return ()
    _, dim = max(candidates)
    return tuple("model" if d == dim else None for d in range(len(shape)))


def _spec_dim(spec: tuple) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _chunk(leaf, dim: int, parts: int, index: int):
    """Chunk ``index`` of ``parts`` equal contiguous chunks of ``leaf``
    along ``dim``, a view (a tensor or a NumPy array)."""
    size = leaf.shape[dim] // parts
    return leaf[(slice(None),) * dim + (slice(index * size, (index + 1) * size),)]


def shard_params(params, mesh: Mesh, model_index: Optional[int] = None):
    """``params`` (tensors or NumPy arrays in nested tuples, lists and
    dicts) with each leaf that :func:`infer_param_spec` shards cut along
    its axis into ``model`` contiguous chunks, of which model index
    ``model_index`` keeps its own (a contiguous copy); replicated leaves
    come back as they are. ``model_index`` defaults to this rank's,
    ``process_index() % model``."""
    model_size = mesh.shape["model"]
    if model_index is None:
        model_index = process_index() % model_size

    def shard(leaf):
        dim = _spec_dim(infer_param_spec(leaf, mesh))
        if dim is None:
            return leaf
        part = _chunk(leaf, dim, model_size, model_index)
        if isinstance(part, torch.Tensor):
            return part.clone(memory_format=torch.contiguous_format)
        return np.ascontiguousarray(part)

    return _tree_map(shard, params)


def process_mesh(model: int = 1, device=None) -> Mesh:
    """The run's ``(data, model)`` mesh over its ranks: ``process_count()``
    slots in rank order, ``data = process_count() // model`` (so rank r has
    data index ``r // model`` and model index ``r % model``). A process
    knows only its own device, which stands in every slot. ``model`` (the
    trainer's ``mesh_model_axis``) must divide the world size
    (``ValueError`` otherwise, where the JAX mesh's assertion fails)."""
    world = process_count()
    if model < 1 or world % model:
        raise ValueError(f"mesh_model_axis={model} needs a multiple of {model} processes (one "
                         f"device a process: --distributed with {model}k ranks), got {world}")
    return make_mesh([torch.device(device or "cpu")] * world, model=model)


def model_group(mesh: Mesh):
    """This rank's ``model`` group, the ranks of its data index (None on a
    mesh whose ``model`` axis is 1). Every rank creates every data index's
    group (``dist.new_group``), in order, as ``torch.distributed`` asks."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    if data * model != process_count():
        raise ValueError(f"a {data}x{model} mesh over {process_count()} processes")
    if model == 1:
        return None  # every rank its own group: nothing to gather
    mine = None
    for i in range(data):
        group = dist.new_group(list(range(i * model, (i + 1) * model)))
        if i == process_index() // model:
            mine = group
    return mine


def all_gather_params(shards: Sequence[torch.Tensor], group, size: int) -> torch.Tensor:
    """Every rank of ``group``'s ``shards``, gathered in one collective:
    this rank's tensors (one dtype and device, the same shapes on every
    rank of the group) flattened into one buffer, all-gathered, and
    returned as ``[size, numel]``, a row a rank in group order. NCCL
    gathers on the card (``all_gather_into_tensor``); gloo gathers host
    memory, a card's buffer through pinned host memory and back."""
    collective_counts["all_gather_params"] += 1
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    backend = dist.get_backend(group)
    if backend == "nccl":
        out = flat.new_empty((size, flat.numel()))
        dist.all_gather_into_tensor(out, flat, group=group)
        return out
    through_host = flat.device.type == "cuda"
    if through_host:
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
        out = torch.empty((size, flat.numel()), dtype=flat.dtype, pin_memory=True)
    else:
        host, out = flat, flat.new_empty((size, flat.numel()))
    dist.all_gather(list(out.unbind(0)), host, group=group)
    return out.to(flat.device, non_blocking=True) if through_host else out


def _assemble(rows: torch.Tensor, shards: Sequence[torch.Tensor], dims: Sequence[int]):
    """For each shard of ``shards`` (this rank's, in the gathered order),
    its full tensor's chunks: ``[size]`` views into ``rows``."""
    offset = 0
    for shard, dim in zip(shards, dims):
        n = shard.numel()
        yield dim, [row[offset:offset + n].view(shard.shape) for row in rows]
        offset += n


class ParamShards:
    """This rank's ``model``-axis shards of ``module``'s parameters.

    :attr:`leaves` stands for :meth:`module.parameters`, in its order: for
    a parameter that :func:`infer_param_spec` shards on ``mesh``, this
    rank's chunk as :func:`shard_params` cuts it (a new parameter); for a replicated
    one, the module's own parameter. An optimizer over :attr:`leaves`
    holds its state for the shards alone. Without a mesh (or on one whose
    ``model`` axis is 1) every parameter is replicated: :attr:`leaves` are
    the module's parameters and the methods below gather, cut and free
    no parameter, so a data-parallel or single-process state takes the
    same calls.

    A step calls :meth:`gather` (the full tensors into the module, one
    :func:`all_gather_params` within :func:`model_group`), runs the
    forward and backward and reduces the gradients over every rank, then
    :meth:`grads_to_leaves` (each shard's slice of the full gradient) and,
    after the optimizer, :meth:`release` (the module's sharded tensors
    and their gradients freed: their storage is resized to nothing, so
    between steps the rank holds its shards only; the weights that
    evaluation stacked from the parameters, now stale, go too).
    :meth:`ensure_full` gathers a released module for evaluation and
    callers. :meth:`full_state` and :meth:`load` carry full-shape state
    dicts, the format of a data-parallel checkpoint."""

    def __init__(self, module: torch.nn.Module, mesh: Optional[Mesh] = None) -> None:
        self.module = module
        self.mesh = mesh
        self.size = mesh.shape["model"] if mesh is not None else 1
        self.index = process_index() % self.size
        self.group = model_group(mesh) if mesh is not None else None
        self.names = [name for name, _ in module.named_parameters()]
        self.params = list(module.parameters())
        self.dims = [_spec_dim(infer_param_spec(p, mesh)) if mesh is not None else None
                     for p in self.params]
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.leaves = list(self.params)
        if self.sharded:
            cut = shard_params([p.detach() for p in self.params], mesh, self.index)
            for i in self.sharded:
                self.leaves[i] = torch.nn.Parameter(cut[i])
        self.released = False

    @torch.no_grad()
    def gather(self) -> None:
        """The module's sharded tensors rebuilt from every rank's shards
        (nothing to gather where no parameter is sharded)."""
        sharded = self.sharded
        if not sharded:
            return
        rows = all_gather_params([self.leaves[i] for i in sharded], self.group, self.size)
        self._allocate()
        for i, (dim, chunks) in zip(sharded, _assemble(rows, [self.leaves[i] for i in sharded],
                                                       [self.dims[i] for i in sharded])):
            p = self.params[i]
            size = p.shape[dim] // self.size
            for j, chunk in enumerate(chunks):
                p.narrow(dim, j * size, size).copy_(chunk)

    def _allocate(self) -> None:
        """Storage for the module's released tensors again."""
        if self.released:
            for i in self.sharded:
                p = self.params[i]
                p.untyped_storage().resize_(p.numel() * p.element_size())
            self.released = False

    def ensure_full(self) -> None:
        """:meth:`gather` where the module's tensors are released."""
        if self.released:
            self.gather()

    @torch.no_grad()
    def grads_to_leaves(self) -> None:
        """Each shard's gradient: its slice of the module parameter's full
        (reduced, clipped) gradient, which is freed."""
        for i in self.sharded:
            p = self.params[i]
            if p.grad is not None:
                self.leaves[i].grad = _chunk(p.grad, self.dims[i], self.size, self.index).clone(
                    memory_format=torch.contiguous_format)
                p.grad = None

    def release(self) -> None:
        """Free the module's sharded tensors and their gradients until the
        next :meth:`gather`, and the weights its layers stacked from the
        parameters for evaluation (stale once the optimizer has stepped)."""
        for module in self.module.modules():
            clear = getattr(module, "clear_stacked", None)
            if clear is not None:
                clear()
        if not self.sharded:
            return
        for i in self.sharded:
            p = self.params[i]
            p.grad = None
            p.untyped_storage().resize_(0)
        self.released = True

    def full_state(self, optimizer: torch.optim.Optimizer):
        """``(module state dict, optimizer state dict)`` at full shape, the
        shards and their Adam moments gathered in one collective, which
        every rank of the model group joins."""
        sharded = self.sharded
        if not sharded:
            return self.module.state_dict(), optimizer.state_dict()
        # a leaf whose gradient stayed None has no moments; every rank
        # agrees on which those are (the gradients are summed over all)
        states = [optimizer.state.get(self.leaves[i], {}) for i in sharded]
        parts = [(i, None, self.leaves[i]) for i in sharded] + [
            (i, name, s[name]) for name in ("exp_avg", "exp_avg_sq")
            for i, s in zip(sharded, states) if name in s]
        rows = all_gather_params([t for _, _, t in parts], self.group, self.size)
        module_sd = self.module.state_dict()
        opt_sd = optimizer.state_dict()
        opt_sd["state"] = {k: dict(v) for k, v in opt_sd["state"].items()}  # not the live dicts
        for (i, name, _), (dim, chunks) in zip(parts, _assemble(
                rows, [t for _, _, t in parts], [self.dims[i] for i, _, _ in parts])):
            full = torch.cat(chunks, dim=dim)
            if name is None:
                module_sd[self.names[i]] = full
            else:
                opt_sd["state"][i][name] = full
        return module_sd, opt_sd

    @torch.no_grad()
    def load(self, module_sd, opt_sd, optimizer: torch.optim.Optimizer) -> None:
        """Full-shape state dicts (:meth:`full_state`'s, or a
        data-parallel run's) into the module, the shards and
        ``optimizer``, which keeps each shard's slice of the moments (a
        moment has its parameter's shape, so :func:`shard_params` cuts it
        as it cuts the parameter; Adam's scalar step stays whole)."""
        self._allocate()
        self.module.load_state_dict(module_sd)
        if self.sharded:
            cut = shard_params([p.detach() for p in self.params], self.mesh, self.index)
            for i in self.sharded:
                self.leaves[i].copy_(cut[i])
            opt_sd = {**opt_sd, "state": {k: shard_params(dict(v), self.mesh, self.index)
                                          for k, v in opt_sd["state"].items()}}
        optimizer.load_state_dict(opt_sd)
