"""Data and tensor parallelism: device meshes for serving, one process a
device joined by ``torch.distributed`` for training, parameters and Adam
state sharded on a ``model`` axis (``parallel/mesh.py``)."""

from .mesh import (
    Mesh, ParamShards, all_reduce_gradients, fit_mesh_for_batch, infer_param_spec,
    init_distributed, make_mesh, mesh_spans_processes, pad_batch_to_multiple, process_count,
    process_index, replicate, shard_batch, shard_params, shutdown_distributed,
)

__all__ = [
    "Mesh", "make_mesh", "fit_mesh_for_batch", "pad_batch_to_multiple", "shard_batch",
    "replicate", "mesh_spans_processes", "init_distributed", "shutdown_distributed",
    "process_index", "process_count", "all_reduce_gradients", "infer_param_spec",
    "shard_params", "ParamShards",
]
