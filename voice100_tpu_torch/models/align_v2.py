"""v2 TTS duration model: TextToAlignText.

Port of ``voice100_tpu/models/align_v2.py``: embedding -> stacked biLSTM
-> dense(2), predicting per-token ``log(1 + frames)`` pairs (frames
before, frames during); ``predict`` returns ``exp(y) - 1``; ``align``
expands a batch of texts by such durations
(:func:`voice100_tpu_torch.ops.duration.expand_alignment_batch`);
``compute_loss`` is the masked L1 on ``log(1 + frames)``
(:func:`voice100_tpu_torch.models.losses.duration_loss`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.duration import expand_alignment_batch
from .layers import BiLSTM, uniform_
from .losses import duration_loss

__all__ = ["TextToAlignText"]


class TextToAlignText(nn.Module):
    """``[B, L]`` token ids -> ``[B, L, num_outputs]`` log-durations, on
    ``device`` (default ``cuda``) with weights drawn from ``generator``.
    Parameter names follow the torch reference (``embedding.weight``,
    ``lstm.*``, ``dense.*``)."""

    def __init__(
        self,
        vocab_size: int,
        num_layers: int = 2,
        hidden_size: int = 256,
        num_outputs: int = 2,
        learning_rate: float = 1e-3,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.learning_rate = learning_rate
        self.embedding = nn.Embedding(vocab_size, hidden_size, device=device)
        self.lstm = BiLSTM(hidden_size, hidden_size, num_layers, dropout=0.2, device=device)
        self.dense = nn.Linear(2 * hidden_size, num_outputs, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Embedding from N(0, 1), the rest with torch's default bounds,
        all drawn from ``generator`` on the CPU."""
        with torch.no_grad():
            self.embedding.weight.copy_(torch.randn(self.embedding.weight.shape,
                                                    generator=generator))
        self.lstm.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.dense.in_features)
        uniform_(self.dense.weight, bound, generator)
        uniform_(self.dense.bias, bound, generator)

    def forward(self, text: torch.Tensor, text_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``([B, L], [B]) -> [B, L, num_outputs]``; in training mode the
        biLSTM applies its inter-layer dropout, drawing from ``generator``."""
        x = self.embedding(text.long())
        return self.dense(self.lstm(x, text_len, generator))

    def compute_loss(self, text: torch.Tensor, text_len: torch.Tensor, align: torch.Tensor,
                     align_len: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Masked L1 on ``log(1 + frames)``. ``align`` arrives flat
        ``[B, 2L(+1)]`` from the align-text files: its trailing odd slot is
        dropped and the rest read as ``[B, L', 2]`` pairs. The mask is
        ``text_len``'s, as in the reference (``align_len`` is not read),
        over the first ``min(L, L')`` tokens. ``deterministic`` is the
        JAX signature's; dropout follows the module's training mode."""
        del align_len, deterministic
        batch = align.shape[0]
        usable = (align.shape[1] - 1) // 2 * 2
        pairs = align[:, :usable].reshape(batch, -1, 2)
        pred = self(text, text_len, generator)
        n = min(pred.shape[1], pairs.shape[1])
        return duration_loss(pred[:, :n], pairs[:, :n], text[:, :n], text_len)

    @torch.inference_mode()
    def predict(self, text: torch.Tensor, text_len: torch.Tensor) -> torch.Tensor:
        """Durations in frames, ``exp(y) - 1`` (may be negative)."""
        return torch.exp(self(text, text_len)) - 1.0

    def align(self, text: torch.Tensor, align, text_len: torch.Tensor, out_len: int,
              head: int = 5, tail: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
        """Expand a batch of texts by durations ``align [B, L, 2]`` (a
        tensor, or the host array a caller already fetched) into
        ``[B, out_len]`` aligned ids and their lengths, on ``text``'s
        device."""
        if isinstance(align, torch.Tensor):
            align = align.cpu().numpy()
        return expand_alignment_batch(text, np.asarray(align), text_len, out_len,
                                      head=head, tail=tail)
