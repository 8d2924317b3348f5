"""Checkpoint save and restore through ``torch.save``.

Port of ``voice100_tpu/training/checkpoint.py:20-55, 87-95``: a checkpoint
holds the model's state dict, the optimizer's state dict, and the step,
epoch and best monitored value of a :class:`TrainState`;
:func:`load_model_weights` reads back the model's weights alone. An orbax
checkpoint of the JAX package cannot be read without jax; weights cross
over through ``tools/weights.py``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

__all__ = ["TrainState", "save_checkpoint", "restore_checkpoint", "load_model_weights"]


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
