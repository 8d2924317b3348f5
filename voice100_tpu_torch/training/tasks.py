"""Task adapters: (model, batch layout) -> loss, metrics and optimizer.

Port of ``voice100_tpu/training/tasks.py``:

* ``AudioToAlignText``, ``TextToAlignText``, ``ConformerCTC`` and the v1
  ``AudioToTextCTC``, ``AudioAlignCTC`` and ``TextToAlignTextModel``: a
  pair batch ``((a, a_len), (b, b_len))`` (audio and text, or text and
  the flat durations), one scalar loss;
* ``AlignTextToAudio``: a WORLD batch ``((f0, f0_len, logspc, codeap),
  (aligntext, aligntext_len))``, five stream losses summed with the
  model's ``logspc_weight``, each reported under the JAX package's name;
* ``AlignTextToAudioModel``: the WORLD batch, four v1 stream losses
  summed;
* ``AlignTextToAudioMultiTaskModel``: the WORLD batch and ``(phonetext,
  phonetext_len)``, the four stream losses and the phone loss summed.

The v1 models' BatchNorm running averages (flax's ``batch_stats``) are
buffers that a train-mode forward updates, so they move on train steps
only, as the JAX trainer's mutable collection does.

A batch's leaves move to the model's device; half-precision features are
widened to float32 there (``upcast_float_inputs``, ``tasks.py:66-75``).
Under a bf16 upload (``TrainerConfig.upload_dtype``) the trainer first
rounds a train batch's float32 INPUT leaves to bf16 on the host through
``Task.upload_cast`` (``tasks.py:49-62, 126-131``): the first pair's
array of a pair layout (audio features; int text ids pass), nothing of
the WORLD layout, whose float leaves are supervision targets. Targets
never quantize, and the float16 feature cache is left as it is.

Each model's optimizer is plain Adam at its ``learning_rate``, except
``AudioToTextCTC``'s: AdamW with weight decay ``model.weight_decay`` on
every parameter (optax's default mask is none) and the learning rate
``lr * 0.98 ** floor(step / steps_per_epoch)``, counted in optimizer
updates (``tasks.py:166-181``, the reference's StepLR). The task keeps
the schedule as ``lr_schedule``; the trainer sets each step's rate from
it at the state's step, so a resumed run goes on at the right rate.
``ConformerCTC``'s is NeMo's ``adamw`` (betas 0.9 and 0.98, eps 1e-8,
weight decay ``model.weight_decay`` on every parameter) under
``NoamAnnealing`` (``models.conformer_ctc.noam_lr`` at the step, at least
1, as NeMo's scheduler evaluates it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import (AlignTextToAudio, AlignTextToAudioModel, AlignTextToAudioMultiTaskModel,
                      AudioAlignCTC, AudioToAlignText, AudioToTextCTC, ConformerCTC,
                      TextToAlignText, TextToAlignTextModel)

__all__ = ["Task", "make_task"]

Metrics = Dict[str, Any]


def _upcast(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t


def _pair_args(batch):
    (a, a_len), (b, b_len) = batch
    return (a, a_len, b, b_len)


def _world_args(batch):
    (f0, f0_len, logspc, codeap), (text, text_len) = batch
    return (f0, f0_len, logspc, codeap, text, text_len)


def _world_target_args(batch):
    (f0, f0_len, logspc, codeap), (t, t_len), (g, g_len) = batch
    return (f0, f0_len, logspc, codeap, t, t_len, g, g_len)


def _pair_upload_cast(batch, cast):
    """The bf16 upload of a pair layout: only the first pair's array is a
    model input; the second pair is supervision and uploads as collated."""
    (a, a_len), (b, b_len) = batch
    return ((cast(a), a_len), (b, b_len))


def _no_upload_cast(batch, cast):
    """The WORLD layout: float supervision targets and integer text
    inputs, nothing that may quantize on upload."""
    return batch


def _scalar_post(model, values) -> Tuple[torch.Tensor, Metrics]:
    return values, {"loss": values}


def _tts_v2_post(model, values) -> Tuple[torch.Tensor, Metrics]:
    loss = AlignTextToAudio.total_loss(values, model.logspc_weight)
    return loss, {"loss": loss, "hasf0_loss": values.hasf0, "f0_loss": values.f0,
                  "logspc_loss": values.logspc, "hascodeap_loss": values.hascodeap,
                  "codeap_loss": values.codeap}


def _tts_v1_post(model, values) -> Tuple[torch.Tensor, Metrics]:
    hasf0_loss, f0_loss, logspc_loss, codeap_loss = values
    loss = hasf0_loss + f0_loss + logspc_loss + codeap_loss
    return loss, {"loss": loss, "hasf0_loss": hasf0_loss, "f0_loss": f0_loss,
                  "logspc_loss": logspc_loss, "codeap_loss": codeap_loss}


def _tts_mt_post(model, values) -> Tuple[torch.Tensor, Metrics]:
    loss = sum(values)
    names = ("hasf0_loss", "f0_loss", "logspc_loss", "codeap_loss", "phone_loss")
    return loss, {"loss": loss, **dict(zip(names, values))}


class Task:
    """Loss, metrics and optimizer of a model over one batch layout:
    ``extract_args`` turns a collated batch into ``compute_loss``'s
    arguments, ``postprocess`` its values into ``(loss, metrics)``."""

    def __init__(self, model, extract_args: Callable = _pair_args,
                 postprocess: Callable = _scalar_post) -> None:
        self.model = model
        self.extract_args = extract_args
        self.postprocess = postprocess
        # which batch leaves may quantize on a bf16 upload: inputs only
        self.upload_cast = _pair_upload_cast if extract_args is _pair_args else _no_upload_cast
        # the learning rate at an optimizer step (make_optimizer sets it)
        self.lr_schedule: Optional[Callable[[int], float]] = None

    def loss(self, batch, train: bool,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Metrics]:
        """``(loss, metrics)`` of one batch. ``train`` turns on the model's
        training mode (dropout) and the ASR augmentation, both drawing
        from ``generator``; with ``train=False`` neither runs. Tensors of
        the batch, or the numpy arrays of the port's collates, move to the
        model's device."""
        self.model.train(train)
        values = self.model.compute_loss(*self.upload(batch), deterministic=not train,
                                         generator=generator)
        return self.postprocess(self.model, values)

    def upload(self, batch) -> Tuple[torch.Tensor, ...]:
        """The ``compute_loss`` arguments of a collated batch on the
        model's device, half-precision features widened to float32. Leaves
        already on the device (the trainer's prefetched batches) are taken
        as they are, without a copy."""
        device = next(self.model.parameters()).device
        return tuple(_upcast(torch.as_tensor(t).to(device, non_blocking=True))
                     for t in self.extract_args(batch))

    def make_optimizer(self, steps_per_epoch: int = 1, params=None) -> torch.optim.Optimizer:
        """Adam at ``model.learning_rate`` with torch's defaults (b1 0.9,
        b2 0.999, eps 1e-8), which are optax.adam's; for
        ``AudioToTextCTC`` AdamW with the model's weight decay on every
        parameter and the staircase ``lr * 0.98 ** (step //
        steps_per_epoch)`` as :attr:`lr_schedule` (torch's default weight
        decay, 0.01, is not optax's, so it is set). ``params`` (default
        the model's parameters) are the tensors it steps: a
        tensor-parallel rank's shards (``parallel.ParamShards.leaves``)."""
        lr = self.model.learning_rate
        params = list(self.model.parameters() if params is None else params)
        if isinstance(self.model, AudioToTextCTC):
            spe = max(int(steps_per_epoch), 1)
            self.lr_schedule = lambda step: lr * 0.98 ** (int(step) // spe)
            return torch.optim.AdamW(params, lr=lr, weight_decay=self.model.weight_decay)
        if isinstance(self.model, ConformerCTC):
            self.lr_schedule = self.model.lr_at
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.98), eps=1e-8,
                                     weight_decay=self.model.weight_decay)
        self.lr_schedule = lambda step: lr
        return torch.optim.Adam(params, lr=lr)


def make_task(model) -> Task:
    if isinstance(model, (AudioToAlignText, TextToAlignText, AudioToTextCTC, AudioAlignCTC,
                          TextToAlignTextModel, ConformerCTC)):
        return Task(model, _pair_args, _scalar_post)
    if isinstance(model, AlignTextToAudio):
        return Task(model, _world_args, _tts_v2_post)
    # the multi-task model is an AlignTextToAudioModel too: it goes first
    if isinstance(model, AlignTextToAudioMultiTaskModel):
        return Task(model, _world_target_args, _tts_mt_post)
    if isinstance(model, AlignTextToAudioModel):
        return Task(model, _world_args, _tts_v1_post)
    raise ValueError(f"No task adapter for {type(model).__name__}")
