"""v2 ASR model: AudioToAlignText, inference.

Port of ``voice100_tpu/models/asr_v2.py:29-53, 89-95``: conv encoder
(time downsampled by its strides), stacked biLSTM, dense projection to
the vocabulary; batch-major logits ``[B, T, V]``. ``compute_loss`` and
``ctc_best_path`` wait for the training and alignment slices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .layers import BiLSTM, ConvSetting, ConvStack, conv_stack_output_length, uniform_

__all__ = ["AudioToAlignText"]


class AudioToAlignText(nn.Module):
    """``[B, T, audio_size]`` log-mel -> ``[B, T', vocab_size]`` logits.

    Built on ``device`` (default ``cuda``; see :func:`resolve_device`) with
    weights drawn from ``generator``. Inference only: call ``.eval()``.
    """

    def __init__(
        self,
        audio_size: int,
        vocab_size: int,
        encoder_settings: Sequence[ConvSetting],
        decoder_num_layers: int = 2,
        decoder_hidden_size: int = 512,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.encoder_settings = tuple(tuple(s) for s in encoder_settings)
        self.encoder = ConvStack(audio_size, self.encoder_settings, device=device)
        self.lstm = BiLSTM(self.encoder_settings[-1][0], decoder_hidden_size,
                           decoder_num_layers, dropout=0.2, device=device)
        self.dense = nn.Linear(2 * decoder_hidden_size, vocab_size, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight from ``generator`` with torch's default bounds."""
        for block in self.encoder:
            block.reset_parameters(generator)
        self.lstm.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.dense.in_features)
        uniform_(self.dense.weight, bound, generator)
        uniform_(self.dense.bias, bound, generator)

    def forward(self, audio: torch.Tensor,
                audio_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``([B, T, audio_size], [B]) -> ([B, T', vocab_size], [B])``."""
        x = self.encoder(audio)
        x_len = conv_stack_output_length(self.encoder_settings, audio_len)
        x = self.lstm(x, x_len)
        return self.dense(x), x_len

    def greedy_decode(self, audio: torch.Tensor,
                      audio_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frame-wise argmax ids and their lengths; the tokenizer decodes
        and merges repeats on the host."""
        logits, logits_len = self(audio, audio_len)
        return logits.argmax(dim=-1), logits_len
