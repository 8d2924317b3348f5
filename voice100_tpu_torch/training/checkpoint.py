"""Checkpoint save and restore through ``torch.save``.

Port of ``voice100_tpu/training/checkpoint.py``: a checkpoint holds the
model's state dict, the optimizer's state dict, and the step, epoch and
best monitored value of a :class:`TrainState`; :func:`load_model_weights`
reads back the model's weights alone, and :func:`merge_world_stats` loads
WORLD feature statistics into a TTS model's ``norm`` buffers. An orbax
checkpoint of the JAX package cannot be read without jax; weights cross
over through ``tools/weights.py``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TrainState", "save_checkpoint", "restore_checkpoint", "load_model_weights",
           "merge_world_stats"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0
    best_monitor: float = float("inf")


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (a file), atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "epoch": state.epoch,
        "best_monitor": state.best_monitor,
    }, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state``'s model and optimizer, in place;
    returns the state with the saved counters."""
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
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
