"""Training loop: train steps, gradient clipping, checkpoints, metric logs.

Port of the subset of ``voice100_tpu/training/trainer.py:41-189, 610-805``
that one device needs: Adam from the task, gradient clipping by global
norm, a JSON log record every ``log_every_n_steps`` steps and at each
epoch's end, the validation loss, and best/last/periodic checkpoints.

The step is ``step_body`` of the JAX trainer (``trainer.py:161-177``):
the loss, its gradients, ``clip_by_global_norm`` then Adam, as
``optax.chain`` runs them. The clip follows optax's rule, not
``torch.nn.utils.clip_grad_norm_``'s: gradients are scaled by
``max / norm`` only when ``norm >= max`` (torch adds 1e-6 to the norm
and scales whenever ``norm > max``).

Not ported yet: meshes and data parallelism, the device feature cache
and multi-step dispatch, profiling, bf16 uploads and the ``bf16``
precision path, the validation CER/WER, signal handling, and the
``fit`` CLI. :meth:`Trainer.fit` takes iterables of collated batches,
the port's ``DataLoader`` among them: it sets the loader's epoch before
each epoch (``set_epoch``), and :meth:`Trainer.evaluate` cuts the rows
that ``pad_to_full`` repeats (``iter_with_counts``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import torch

from .checkpoint import TrainState, restore_checkpoint, save_checkpoint
from .tasks import Task, make_task

__all__ = ["Trainer", "TrainerConfig", "TrainState", "clip_by_global_norm"]


@dataclass
class TrainerConfig:
    max_epochs: int = 1
    gradient_clip_val: float = 1.0
    checkpoint_dir: Optional[str] = None
    monitor: str = "val_loss"
    every_n_epochs: int = 10
    save_last: bool = True
    log_every_n_steps: int = 10
    seed: int = 1234
    log_path: Optional[str] = None
    # "32" only: the bf16 mixed-precision path is not ported yet
    precision: str = "32"


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``max_norm / norm``
    when their global norm reaches ``max_norm`` (``optax.clip_by_global_norm``);
    returns the norm before clipping. Stays on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _iter_counted(batches):
    """``(batch, n_real)`` pairs: the loader's own counts where it has
    them, else every row of each batch."""
    if hasattr(batches, "iter_with_counts"):
        yield from batches.iter_with_counts()
    else:
        for batch in batches:
            yield batch, int(batch[0][0].shape[0])


class Trainer:
    def __init__(self, config: TrainerConfig) -> None:
        if str(config.precision) != "32":
            raise ValueError(f"precision {config.precision!r}: only '32' is ported; "
                             f"the bf16 mixed-precision path is not ported yet")
        self.config = config
        self._log_file = None
        if config.log_path:
            os.makedirs(os.path.dirname(config.log_path) or ".", exist_ok=True)
            self._log_file = open(config.log_path, "a")

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    def _log(self, record: Dict[str, Any]) -> None:
        msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items())
        print(f"[trainer] {msg}", flush=True)
        if self._log_file:
            self._log_file.write(json.dumps(record) + "\n")
            self._log_file.flush()

    def train_step(self, task: Task, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, train: bool = True):
        """One optimizer step on ``batch``; returns the metrics as device
        tensors. ``train=False`` runs it without augmentation and dropout
        (the JAX ``task.loss(..., train=False)``)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = task.loss(batch, train, generator)
        loss.backward()
        if self.config.gradient_clip_val and self.config.gradient_clip_val > 0:
            clip_by_global_norm(state.model.parameters(), self.config.gradient_clip_val)
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def evaluate(self, task: Task, state: TrainState, batches: Iterable) -> Dict[str, float]:
        """Metrics over ``batches``, each batch weighted by its real rows,
        so the result does not depend on ``pad_to_full``: a loader with
        ``iter_with_counts`` says how many leading rows of each batch are
        real, and the repeated rows after them are cut before the loss
        (``voice100_tpu/training/trainer.py:807-849`` on one process).
        Other iterables count every row."""
        totals: Dict[str, float] = {}
        count = 0
        for batch, n_real in _iter_counted(batches):
            if n_real < int(batch[0][0].shape[0]):
                batch = tuple(tuple(t[:n_real] for t in pair) for pair in batch)
            _, metrics = task.loss(batch, train=False)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n_real
            count += n_real
        return {k: v / max(count, 1) for k, v in totals.items()}

    def fit(self, model, train_batches: Iterable, val_batches: Optional[Iterable] = None,
            restore_from: Optional[str] = None) -> TrainState:
        """Train ``model`` for ``max_epochs`` over ``train_batches``, an
        iterable of collated ``((audio, audio_len), (text, text_len))``
        batches that can be iterated once per epoch (a list, or a
        re-iterable loader, whose ``set_epoch(epoch)`` is called before
        each epoch, as ``voice100_tpu/training/trainer.py:614`` does);
        ``restore_from`` resumes from a checkpoint."""
        cfg = self.config
        task = make_task(model)
        state = TrainState(model, task.make_optimizer())
        if restore_from:
            state = restore_checkpoint(restore_from, state)
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        for epoch in range(state.epoch, cfg.max_epochs):
            if hasattr(train_batches, "set_epoch"):
                train_batches.set_epoch(epoch)
            start = time.time()
            running = None
            for batch in train_batches:
                running = self.train_step(task, state, batch, generator)
                if state.step % cfg.log_every_n_steps == 0:
                    self._log({"epoch": epoch, "step": state.step,
                               **{f"train_{k}": float(v) for k, v in running.items()}})
            self._epoch_tail(task, state, epoch, start, running, val_batches)
        return state

    def _epoch_tail(self, task, state, epoch, start, running, val_batches) -> None:
        """The epoch record, validation and checkpoints."""
        cfg = self.config
        record = {"epoch": epoch, "step": state.step,
                  "train_time_s": round(time.time() - start, 2),
                  "lr": float(state.optimizer.param_groups[0]["lr"])}
        if running is not None:
            record["train_loss"] = float(running["loss"])
        val_metrics = {}
        if val_batches is not None:
            val_metrics = self.evaluate(task, state, val_batches)
            record.update({f"val_{k}": v for k, v in val_metrics.items()})
        self._log(record)
        if cfg.monitor == "val_loss":
            monitor = val_metrics.get("loss")
        else:
            monitor = record.get("train_loss")
        state.epoch = epoch + 1
        if cfg.checkpoint_dir:
            if monitor is not None and monitor < state.best_monitor:
                state.best_monitor = monitor
                save_checkpoint(os.path.join(cfg.checkpoint_dir, "best.pt"), state)
            if cfg.save_last:
                save_checkpoint(os.path.join(cfg.checkpoint_dir, "last.pt"), state)
            if (epoch + 1) % cfg.every_n_epochs == 0:
                save_checkpoint(os.path.join(cfg.checkpoint_dir, f"epoch_{epoch + 1}.pt"), state)
