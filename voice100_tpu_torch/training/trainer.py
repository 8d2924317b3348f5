"""Training loop: train steps, gradient clipping, checkpoints, metric logs.

Port of ``voice100_tpu/training/trainer.py`` for one device: Adam from
the task, gradient clipping by global norm, a JSON log record at the
start of a fit, every ``log_every_n_steps`` steps and at each epoch's
end, the validation loss (and CER and WER for CTC models),
best/last/periodic checkpoints, the WORLD identity-statistics warning,
and a graceful stop (SIGTERM, SIGINT or :meth:`Trainer.request_stop`).

:meth:`Trainer.fit` takes a data module, as the JAX trainer does: it
calls ``setup("fit")``, trains over the train loader (its prefetch
thread) and validates over the val loader. It also takes iterables of
collated batches, the port's ``DataLoader`` among them. Either way the
loader's epoch is set before each epoch (``set_epoch``), and evaluation
cuts the rows that ``pad_to_full`` repeats (``iter_with_counts``).

The step is ``step_body`` of the JAX trainer (``trainer.py:161-177``):
the loss, its gradients, ``clip_by_global_norm`` then Adam, as
``optax.chain`` runs them. The clip follows optax's rule, not
``torch.nn.utils.clip_grad_norm_``'s: gradients are scaled by
``max / norm`` only when ``norm >= max`` (torch adds 1e-6 to the norm
and scales whenever ``norm > max``).

The trainer runs on the model's device and never moves it: a model
built for ``cuda`` on a machine without CUDA has raised already
(:func:`voice100_tpu_torch.device.resolve_device`). Float32 only: another
``precision`` raises. The JAX trainer's meshes, device feature cache,
multi-step dispatch, profiling and bf16 uploads are not ported; their
settings have no field here, and a config that sets them raises
(``training/cli.py`` ``UNPORTED``).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..ops.metrics import error_rate
from .checkpoint import TrainState, restore_checkpoint, save_checkpoint
from .tasks import Task, make_task

__all__ = ["Trainer", "TrainerConfig", "TrainState", "clip_by_global_norm"]

BF16_ITEM = "ROADMAP.md queue 1, item 5: the bf16 precision path"
# the JAX trainer's words (voice100_tpu/training/trainer.py:293-297)
IDENTITY_STATS_WARNING = ("WORLD norm stats are identity; run tools.calc_stat and pass "
                          "--audio_stat, or the f0 stream will dominate the TTS loss")


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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Trainer:
    def __init__(self, config: TrainerConfig) -> None:
        if str(config.precision) != "32":
            raise ValueError(f"precision {config.precision!r}: only '32' is ported; "
                             f"the bf16 mixed-precision path is not ported yet ({BF16_ITEM})")
        self.config = config
        self._stop_requested = False
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

    def request_stop(self) -> None:
        """The programmatic SIGTERM: stop after the current step, saving
        the ``last`` checkpoint. Armed before :meth:`fit`, it stops after
        the first step."""
        self._stop_requested = True

    def _install_stop_handlers(self):
        """SIGTERM and SIGINT (preemption, ^C) request a stop; a second
        signal raises ``KeyboardInterrupt``, so a hung step can still be
        interrupted. Only the main thread can install handlers; returns
        the ones it replaced."""
        if threading.current_thread() is not threading.main_thread():
            return []

        def on_signal(signum, frame):
            if self._stop_requested:
                raise KeyboardInterrupt
            self._log({"event": "stop_requested", "signal": int(signum)})
            self._stop_requested = True

        installed = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                installed.append((sig, signal.signal(sig, on_signal)))
            except (ValueError, OSError):
                pass
        return installed

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

    @torch.no_grad()
    def _val_cer(self, model, datamodule, batches) -> Optional[Dict[str, float]]:
        """Greedy-decode character (and word) error rates over
        ``batches`` (``voice100_tpu/training/trainer.py:852-937`` on one
        process): ``greedy_decode`` -> ``tokenizer.decode`` ->
        ``merge_repeated`` against each real row's decoded text. WER only
        where decoded text has word boundaries (char tokenizers: the
        phone tokenizers join with a ``_separator``). None without the
        data module's tokenizer."""
        tokenizer = getattr(datamodule, "text_transform", None)
        if tokenizer is None or not hasattr(type(model), "greedy_decode"):
            return None
        task = make_task(model)
        model.eval()
        word_level = not hasattr(tokenizer, "_separator")
        edits = total = w_edits = w_total = 0
        for batch, n_real in _iter_counted(batches):
            audio, audio_len, _, _ = task.upload(batch)
            ids, out_len = (_host(t) for t in model.greedy_decode(audio, audio_len))
            text, text_len = (_host(t) for t in batch[1])
            refs = [tokenizer.decode(text[i, :int(text_len[i])]) for i in range(n_real)]
            hyps = [tokenizer.merge_repeated(tokenizer.decode(ids[i, :int(out_len[i])]))
                    for i in range(n_real)]
            e, t = error_rate(refs, hyps)
            edits, total = edits + e, total + t
            if word_level:
                e, t = error_rate([r.split() for r in refs], [h.split() for h in hyps])
                w_edits, w_total = w_edits + e, w_total + t
        rates = {"cer": edits / max(total, 1)}
        if word_level:
            rates["wer"] = w_edits / max(w_total, 1)
        return rates

    def run_eval(self, model, datamodule, state: Optional[TrainState] = None,
                 stage: str = "test") -> Dict[str, float]:
        """Loss, CER and WER of ``state``'s model (default ``model``) over
        a stage of ``datamodule``: ``"test"`` its test split, any other
        stage the val split of ``setup(stage)`` (the reference's
        ``voice100 validate`` and ``test``; ``trainer.py:948-968``, which
        the JAX CLI follows with ``_val_cer``)."""
        model = state.model if state is not None else model
        datamodule.setup(stage)
        loader = datamodule.test_dataloader() if stage == "test" else datamodule.val_dataloader()
        metrics = self.evaluate(make_task(model), state, loader)
        metrics.update(self._val_cer(model, datamodule, loader) or {})
        return metrics

    def fit(self, model, data, val_batches: Optional[Iterable] = None,
            restore_from: Optional[str] = None) -> TrainState:
        """Train ``model`` for ``max_epochs``; ``restore_from`` resumes
        from a checkpoint (the epoch it saved, from that epoch's start).

        ``data`` is a data module (``setup("fit")``, then its train and
        val loaders; ``voice100_tpu/training/trainer.py:233-370``), or a
        sized iterable of collated batches in the model's task layout
        (``training/tasks.py``) that can be iterated once an epoch (a
        list, or a re-iterable loader) with ``val_batches`` beside it.

        A model with WORLD statistics (``norm``) that are still the
        identity after any restore logs the JAX trainer's warning record
        first: calc_stat was never run.

        On a stop request the current step finishes, ``{"event":
        "stopped"}`` is logged, ``last.pt`` saved and the state returned."""
        cfg = self.config
        datamodule = None
        if hasattr(data, "setup") and hasattr(data, "train_dataloader"):
            if val_batches is not None:
                raise TypeError("fit on a data module takes its val loader; pass restore_from "
                                "by keyword")
            datamodule = data
            datamodule.setup("fit")
            train_batches, val_batches = data.train_dataloader(), data.val_dataloader()
        else:
            train_batches = data
        task = make_task(model)
        state = TrainState(model, task.make_optimizer())
        if restore_from:
            state = restore_checkpoint(restore_from, state)
        device = next(model.parameters()).device
        norm = getattr(model, "norm", None)
        if norm is not None and float((norm.f0_std - 1.0).abs().max()) < 1e-6:
            # identity statistics mean calc_stat never ran: the raw f0
            # stream (hundreds of Hz) then dominates the WORLD loss
            self._log({"event": "warning", "message": IDENTITY_STATS_WARNING})
        self._log({"event": "fit_start", "params": sum(p.numel() for p in model.parameters()),
                   "steps_per_epoch": len(train_batches), "device": str(device)})
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        installed = self._install_stop_handlers()
        try:
            return self._fit_loop(task, state, generator, train_batches, val_batches, datamodule)
        finally:
            # a reused Trainer must not stop at once on its next fit (a
            # request armed before fit still stops that fit)
            self._stop_requested = False
            for sig, old in installed:
                signal.signal(sig, old)

    def _fit_loop(self, task, state, generator, train_batches, val_batches, datamodule):
        cfg = self.config
        for epoch in range(state.epoch, cfg.max_epochs):
            if hasattr(train_batches, "set_epoch"):
                train_batches.set_epoch(epoch)
            start = time.time()
            running = None
            batches = iter(train_batches)
            try:
                for batch in batches:
                    running = self.train_step(task, state, batch, generator)
                    if self._stop_requested:
                        self._log({"event": "stopped", "epoch": epoch, "step": state.step})
                        state.epoch = epoch  # a resume re-runs this epoch
                        if cfg.checkpoint_dir and cfg.save_last:
                            save_checkpoint(os.path.join(cfg.checkpoint_dir, "last.pt"), state)
                        return state
                    if state.step % cfg.log_every_n_steps == 0:
                        self._log({"epoch": epoch, "step": state.step,
                                   **{f"train_{k}": float(v) for k, v in running.items()}})
            finally:
                # ends a loader's prefetch thread when the loop leaves early
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            self._epoch_tail(task, state, epoch, start, running, val_batches, datamodule)
        return state

    def _epoch_tail(self, task, state, epoch, start, running, val_batches, datamodule) -> None:
        """The epoch record, validation and checkpoints."""
        cfg = self.config
        record = {"epoch": epoch, "step": state.step,
                  "train_time_s": round(time.time() - start, 2),
                  "lr": float(state.optimizer.param_groups[0]["lr"])}
        if running is not None:
            record["train_loss"] = float(running["loss"])
        val_metrics = {}
        if val_batches is not None and len(val_batches) > 0:
            val_metrics = self.evaluate(task, state, val_batches)
            val_metrics.update(self._val_cer(state.model, datamodule, val_batches) or {})
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
