"""Task adapters: (model, batch layout) -> loss, metrics and optimizer.

Port of ``voice100_tpu/training/tasks.py:34-41, 80-93, 117-203`` for the
v2 models the port trains:

* ``AudioToAlignText`` and ``TextToAlignText``: a pair batch
  ``((a, a_len), (b, b_len))`` (audio and text, or text and the flat
  durations), one scalar loss;
* ``AlignTextToAudio``: a WORLD batch ``((f0, f0_len, logspc, codeap),
  (aligntext, aligntext_len))``, five stream losses summed with the
  model's ``logspc_weight``, each reported under the JAX package's name.

A batch's leaves move to the model's device; half-precision features are
widened to float32 there (``upcast_float_inputs``). WORLD targets are
never down-cast on the way (``tasks.py:57-61``): the port uploads
float32 as collated. Each model's optimizer is plain Adam at its
``learning_rate``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import AlignTextToAudio, AudioToAlignText, TextToAlignText

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


def _scalar_post(model, values) -> Tuple[torch.Tensor, Metrics]:
    return values, {"loss": values}


def _tts_v2_post(model, values) -> Tuple[torch.Tensor, Metrics]:
    loss = AlignTextToAudio.total_loss(values, model.logspc_weight)
    return loss, {"loss": loss, "hasf0_loss": values.hasf0, "f0_loss": values.f0,
                  "logspc_loss": values.logspc, "hascodeap_loss": values.hascodeap,
                  "codeap_loss": values.codeap}


class Task:
    """Loss, metrics and optimizer of a model over one batch layout:
    ``extract_args`` turns a collated batch into ``compute_loss``'s
    arguments, ``postprocess`` its values into ``(loss, metrics)``."""

    def __init__(self, model, extract_args: Callable = _pair_args,
                 postprocess: Callable = _scalar_post) -> None:
        self.model = model
        self.extract_args = extract_args
        self.postprocess = postprocess

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
        model's device, half-precision features widened to float32."""
        device = next(self.model.parameters()).device
        return tuple(_upcast(torch.as_tensor(t).to(device, non_blocking=True))
                     for t in self.extract_args(batch))

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam at ``model.learning_rate`` with torch's defaults (b1 0.9,
        b2 0.999, eps 1e-8), which are optax.adam's."""
        return torch.optim.Adam(self.model.parameters(), lr=self.model.learning_rate)


def make_task(model) -> Task:
    if isinstance(model, (AudioToAlignText, TextToAlignText)):
        return Task(model, _pair_args, _scalar_post)
    if isinstance(model, AlignTextToAudio):
        return Task(model, _world_args, _tts_v2_post)
    raise ValueError(f"No task adapter for {type(model).__name__}")
