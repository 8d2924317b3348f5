"""Task adapter: (model, batch layout) -> loss, metrics and optimizer.

Port of the ASR part of ``voice100_tpu/training/tasks.py:34-36, 80-81,
117-186``. A collated batch ``((audio, audio_len), (text, text_len))``
becomes the arguments of ``compute_loss``; half-precision inputs are
upcast to float32 first, as ``upcast_float_inputs`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import AudioToAlignText

__all__ = ["Task", "make_task"]

Metrics = Dict[str, Any]


def _upcast(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t


class Task:
    """Loss and optimizer of a model that maps an audio/text pair batch to
    one scalar loss (``AudioToAlignText``)."""

    def __init__(self, model) -> None:
        self.model = model

    def loss(self, batch, train: bool,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Metrics]:
        """``(loss, {"loss": loss})`` of one batch. ``train`` turns on the
        model's training mode (dropout) and augmentation, both drawing
        from ``generator``; with ``train=False`` neither runs. Tensors of
        the batch, or the numpy arrays of the port's collates, move to the
        model's device."""
        self.model.train(train)
        loss = self.model.compute_loss(*self.upload(batch), deterministic=not train,
                                       generator=generator)
        return loss, {"loss": loss}

    def upload(self, batch) -> Tuple[torch.Tensor, ...]:
        """``(audio, audio_len, text, text_len)`` of a collated batch on the
        model's device, half-precision features widened to float32."""
        device = next(self.model.parameters()).device
        (audio, audio_len), (text, text_len) = batch
        return tuple(_upcast(torch.as_tensor(t).to(device, non_blocking=True))
                     for t in (audio, audio_len, text, text_len))

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam at ``model.learning_rate`` with torch's defaults (b1 0.9,
        b2 0.999, eps 1e-8), which are optax.adam's."""
        return torch.optim.Adam(self.model.parameters(), lr=self.model.learning_rate)


def make_task(model) -> Task:
    if isinstance(model, AudioToAlignText):
        return Task(model)
    raise ValueError(f"No task adapter for {type(model).__name__}")
