"""Checkpoint save and restore through ``torch.save``.

Port of ``voice100_tpu/training/checkpoint.py``: a checkpoint holds the
model's state dict, the optimizer's state dict, and the step, epoch and
best monitored value of a :class:`TrainState`; :func:`load_model_weights`
reads back the model's weights alone, and :func:`merge_world_stats` loads
WORLD feature statistics into a TTS model's ``norm`` buffers. An orbax
checkpoint of the JAX package cannot be read without jax; weights cross
over through ``tools/weights.py``.

In a data-parallel run (``parallel/mesh.py``) rank 0 writes a checkpoint,
every rank waits for the write, and every rank reads: the ranks hold the
same state. On a tensor-parallel mesh (a :class:`TrainState` whose
``shards`` cut parameters) every rank joins one all-gather of the shards
and their Adam moments, and rank 0 writes the full tensors, so the file
is the same format as a data-parallel run's: it loads in ``load_model``,
and it
resumes on either layout; restoring onto a tensor-parallel mesh keeps
each rank's slices (``voice100_tpu/training/trainer.py:313-321``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..parallel import mesh as parallel

__all__ = ["TrainState", "save_checkpoint", "restore_checkpoint", "load_model_weights",
           "merge_world_stats"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0
    best_monitor: float = float("inf")
    # the leaves ``optimizer`` steps: a tensor-parallel rank's shards, or
    # (by default) the model's parameters, every one replicated
    shards: Optional[parallel.ParamShards] = None

    def __post_init__(self) -> None:
        if self.shards is None:
            self.shards = parallel.ParamShards(self.model)


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (a file), atomically: rank 0 writes,
    and every rank of a process group waits for it, so that none reads
    the checkpoint before it exists. On a tensor-parallel mesh every rank
    must call it: the full tensors are gathered first."""
    model_sd, opt_sd = state.shards.full_state(state.optimizer)
    if parallel.process_index() == 0:
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({
            "model": model_sd,
            "optimizer": opt_sd,
            "step": state.step,
            "epoch": state.epoch,
            "best_monitor": state.best_monitor,
        }, tmp)
        os.replace(tmp, path)
    parallel.barrier()


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state``'s model and optimizer, in place
    (on a tensor-parallel mesh, this rank's slices of the parameters and
    moments into its shards); returns the state with the saved counters."""
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    state.shards.load(saved["model"], saved["optimizer"], state.optimizer)
    return dataclasses.replace(state, step=int(saved["step"]), epoch=int(saved["epoch"]),
                               best_monitor=float(saved["best_monitor"]))


def load_model_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the model weights of a checkpoint that :func:`save_checkpoint`
    wrote into ``model``, in place, on the model's device; returns the
    model (the counterpart of ``load_variables``)."""
    device = next(model.parameters()).device
    saved = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    model.load_state_dict(saved["model"])
    return model


def merge_world_stats(model: torch.nn.Module, stat_path: str) -> torch.nn.Module:
    """Overwrite the WORLDNorm statistics of ``model`` (its ``norm``
    buffers ``f0_mean`` ... ``codeap_std``), in place, from a calc-stat
    ``.npz`` or a reference ``{ds}-stat.pt`` state dict (voice100/
    calc_stat.py:59-68) with those keys (``voice100_tpu/training/
    checkpoint.py:58-90``); keys the file lacks keep their values. A model
    without ``norm`` is returned as it is."""
    norm = getattr(model, "norm", None)
    if norm is None:
        return model
    if stat_path.endswith((".pt", ".pth", ".ckpt")):
        raw = torch.load(stat_path, map_location="cpu", weights_only=True)
        stats = {k: np.asarray(v) for k, v in raw.items() if isinstance(v, torch.Tensor)}
    else:
        with np.load(stat_path) as f:
            stats = dict(f)
    with torch.no_grad():
        for key, buf in norm.named_buffers():
            if key in stats:
                buf.copy_(torch.from_numpy(stats[key].astype(np.float32).reshape(buf.shape)))
    return model
