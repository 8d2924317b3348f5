"""v2 ASR model: AudioToAlignText, inference and training loss.

Port of ``voice100_tpu/models/asr_v2.py``: conv encoder (time
downsampled by its strides), stacked biLSTM, dense projection to the
vocabulary; batch-major logits ``[B, T, V]``; the CTC training loss with
spectrogram augmentation; greedy decoding; and batched CTC Viterbi
forced alignment (``ctc_best_path``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops.augment import apply_augment, draw_augment
from ..ops.ctc import ViterbiResult
from ..ops.ctc_cuda import ctc_loss_cuda
from ..ops.viterbi_cuda import ctc_viterbi_align_cuda
from .layers import BiLSTM, ConvSetting, ConvStack, conv_stack_output_length, uniform_

__all__ = ["AudioToAlignText"]


class AudioToAlignText(nn.Module):
    """``[B, T, audio_size]`` log-mel -> ``[B, T', vocab_size]`` logits.

    Built on ``device`` (default ``cuda``; see :func:`resolve_device`) with
    weights drawn from ``generator``. In training mode the biLSTM applies
    its inter-layer dropout; ``learning_rate`` is the Adam rate the
    training task uses (``voice100_tpu/models/asr_v2.py:35``).
    """

    def __init__(
        self,
        audio_size: int,
        vocab_size: int,
        encoder_settings: Sequence[ConvSetting],
        decoder_num_layers: int = 2,
        decoder_hidden_size: int = 512,
        learning_rate: float = 1e-3,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.audio_size = audio_size
        self.vocab_size = vocab_size
        self.learning_rate = learning_rate
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

    def forward(self, audio: torch.Tensor, audio_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``([B, T, audio_size], [B]) -> ([B, T', vocab_size], [B])``;
        ``generator`` feeds the dropout in training mode."""
        x = self.encoder(audio)
        x_len = conv_stack_output_length(self.encoder_settings, audio_len)
        x = self.lstm(x, x_len, generator)
        return self.dense(x), x_len

    def compute_loss(self, audio: torch.Tensor, audio_len: torch.Tensor, text: torch.Tensor,
                     text_len: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CTC training loss (mean over the batch of each sample's loss
        over its target length): spectrogram augmentation unless
        ``deterministic``, the model, log-softmax, and the lattice kernels
        over the logit lengths. Draws come from ``generator`` (the default
        generator if None), which must lie on the model's device."""
        if not deterministic:
            if generator is None:
                generator = (torch.default_generator if audio.device.type == "cpu" else
                             torch.cuda.default_generators[audio.device.index or 0])
            draws = draw_augment(generator, *audio.shape)
            audio, audio_len = apply_augment(audio, audio_len, draws)
        logits, logits_len = self(audio, audio_len, generator)
        log_probs = torch.log_softmax(logits, dim=-1)
        return ctc_loss_cuda(log_probs, text, logits_len, text_len)

    @torch.inference_mode()
    def ctc_best_path(self, audio: torch.Tensor, audio_len: torch.Tensor, text: torch.Tensor,
                      text_len: torch.Tensor) -> Tuple[ViterbiResult, torch.Tensor]:
        """Batched forced alignment: the model, log-softmax, and the CTC
        Viterbi kernels over the logit lengths. ``text_len`` is capped at
        the logit lengths, which guards very short audio (labels past the
        cap stay in ``text`` and the lattice masks them). Returns the
        Viterbi result and the logit lengths. Runs in inference mode, so
        the biLSTM takes its inference kernel."""
        logits, logits_len = self(audio, audio_len)
        log_probs = torch.log_softmax(logits, dim=-1)
        text_len = torch.minimum(logits_len, text_len.to(logits_len.device))
        return ctc_viterbi_align_cuda(log_probs, text, logits_len, text_len), logits_len

    def greedy_decode(self, audio: torch.Tensor,
                      audio_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frame-wise argmax ids and their lengths; the tokenizer decodes
        and merges repeats on the host."""
        logits, logits_len = self(audio, audio_len)
        return logits.argmax(dim=-1), logits_len
