"""v1 forced aligner: AudioAlignCTC (the deprecated family).

Port of ``voice100_tpu/models/align_v1.py`` (the reference's
voice100/models/align.py:69-180): a Conv1d (k3, stride 2, padding 1,
with bias) and ReLU, a 2-layer biLSTM at H=128 (kernels 1-3 on the
card), a dense layer to the vocabulary; the CTC loss (kernels 4 and 5)
and the batched Viterbi forced alignment (the one launch of kernels 6
and 7). Names follow the torch reference (``conv``, ``lstm``,
``dense``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import default_generator, resolve_device
from ..ops.augment import apply_augment, draw_augment
from ..ops.ctc import ViterbiResult
from ..ops.ctc_cuda import ctc_loss_cuda
from ..ops.viterbi_cuda import ctc_viterbi_align_cuda
from .layers import BiLSTM, reset_conv, uniform_

__all__ = ["AudioAlignCTC"]


class AudioAlignCTC(nn.Module):
    """``([B, T, audio_size], [B]) -> ([B, (T + 1) // 2, vocab_size],
    [B])``, on ``device`` (default ``cuda``) with weights drawn from
    ``generator``. In training mode the biLSTM applies its inter-layer
    dropout 0.2."""

    def __init__(self, audio_size: int, vocab_size: int, hidden_size: int = 128,
                 num_layers: int = 2, learning_rate: float = 1e-3, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.audio_size = audio_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.learning_rate = learning_rate
        self.conv = nn.Conv1d(audio_size, hidden_size, 3, stride=2, padding=1, device=device)
        self.lstm = BiLSTM(hidden_size, hidden_size, num_layers, dropout=0.2, device=device)
        self.dense = nn.Linear(2 * hidden_size, vocab_size, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default bounds, drawn from ``generator`` on the CPU."""
        reset_conv(self.conv, generator)
        self.lstm.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.dense.in_features)
        uniform_(self.dense.weight, bound, generator)
        uniform_(self.dense.bias, bound, generator)

    def forward(self, audio: torch.Tensor, audio_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.conv(audio.transpose(1, 2))).transpose(1, 2)
        x_len = (audio_len + 1) // 2
        x = self.lstm(x, x_len, generator)
        return self.dense(x), x_len

    def compute_loss(self, audio: torch.Tensor, audio_len: torch.Tensor, text: torch.Tensor,
                     text_len: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CTC training loss: spectrogram augmentation unless
        ``deterministic``, the model, log-softmax, and the lattice kernels
        over the logit lengths; draws from ``generator`` (the device's
        default if None)."""
        if not deterministic:
            if generator is None:
                generator = default_generator(audio.device)
            audio, audio_len = apply_augment(audio, audio_len,
                                             draw_augment(generator, *audio.shape))
        logits, logits_len = self(audio, audio_len, generator)
        log_probs = torch.log_softmax(logits, dim=-1)
        return ctc_loss_cuda(log_probs, text, logits_len, text_len)

    @torch.inference_mode()
    def ctc_best_path(self, audio: torch.Tensor, audio_len: torch.Tensor, text: torch.Tensor,
                      text_len: torch.Tensor) -> Tuple[ViterbiResult, torch.Tensor]:
        """Batched forced alignment: the model (the biLSTM's inference
        kernel), log-softmax, and one Viterbi launch over the logit
        lengths, with ``text_len`` capped at them (JAX ``align_v1.py:67``).
        Returns the Viterbi result and the logit lengths."""
        logits, logits_len = self(audio, audio_len)
        log_probs = torch.log_softmax(logits, dim=-1)
        text_len = torch.minimum(logits_len, text_len.to(logits_len.device))
        return ctc_viterbi_align_cuda(log_probs, text, logits_len, text_len), logits_len
