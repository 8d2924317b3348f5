"""Data parallelism: device meshes for serving, one process a device
joined by ``torch.distributed`` for training (``parallel/mesh.py``)."""

from .mesh import (
    TENSOR_PARALLEL_ITEM, Mesh, all_reduce_gradients, fit_mesh_for_batch, init_distributed,
    make_mesh, mesh_spans_processes, pad_batch_to_multiple, process_count, process_index,
    replicate, shard_batch, shutdown_distributed,
)

__all__ = [
    "TENSOR_PARALLEL_ITEM", "Mesh", "make_mesh", "fit_mesh_for_batch", "pad_batch_to_multiple",
    "shard_batch", "replicate", "mesh_spans_processes", "init_distributed",
    "shutdown_distributed", "process_index", "process_count", "all_reduce_gradients",
]
