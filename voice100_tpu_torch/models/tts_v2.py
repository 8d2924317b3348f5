"""v2 TTS acoustic model: AlignTextToAudio.

Port of ``voice100_tpu/models/tts_v2.py``: embedding -> stacked biLSTM ->
conv decoder (time upsampled x2 by a strided transposed conv) -> dense
projection, split into ``[hasf0, f0, logspc or mcep, hascodeap,
codeap]``; ``predict`` unnormalizes with the frozen WORLD statistics and
gates f0 and codeap on the ``has*`` logits; ``compute_loss`` is the
five-stream masked WORLD loss against normalized targets, with the
voicing targets taken from the raw features.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .layers import BiLSTM, ConvSetting, ConvStack, WORLDNorm, conv_stack_output_length, uniform_
from .losses import WORLDLossValues, world_loss_v2

__all__ = ["AlignTextToAudio"]

DEFAULT_DECODER_SETTINGS = (
    # out_channels, transpose, kernel, stride, padding, bias
    (512, False, 5, 1, 2, False),
    (512, True, 5, 2, 2, False),
    (512, False, 5, 1, 2, False),
)


class AlignTextToAudio(nn.Module):
    """``[B, L]`` aligned ids -> WORLD feature streams over ``T ~= 2 L``
    frames, on ``device`` (default ``cuda``) with weights drawn from
    ``generator``. Names follow the torch reference (``embedding.weight``,
    ``lstm.*``, ``decoder.{i}.conv.weight``, ``decoder.{i}.layer_norm.*``,
    ``projection.*``, and the buffers ``norm.*``)."""

    def __init__(
        self,
        vocab_size: int,
        logspc_size: int = 25,
        codeap_size: int = 1,
        encoder_num_layers: int = 2,
        encoder_hidden_size: int = 512,
        decoder_settings: Sequence[ConvSetting] = DEFAULT_DECODER_SETTINGS,
        logspc_weight: float = 5.0,
        learning_rate: float = 1e-3,
        f0_size: int = 1,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.logspc_size = logspc_size
        self.codeap_size = codeap_size
        self.f0_size = f0_size
        self.encoder_num_layers = encoder_num_layers
        self.logspc_weight = logspc_weight
        self.learning_rate = learning_rate
        self.decoder_settings = tuple(tuple(s) for s in decoder_settings)
        self.embedding = nn.Embedding(vocab_size, encoder_hidden_size, device=device)
        self.lstm = BiLSTM(encoder_hidden_size, encoder_hidden_size, encoder_num_layers,
                           dropout=0.2, device=device)
        self.decoder = ConvStack(2 * encoder_hidden_size, self.decoder_settings, device=device)
        self.projection = nn.Linear(self.decoder_settings[-1][0], self.audio_size, device=device)
        self.norm = WORLDNorm(logspc_size, codeap_size, device=device)
        self.reset_parameters(generator)

    @property
    def audio_size(self) -> int:
        return 2 * self.f0_size + self.logspc_size + 2 * self.codeap_size

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Embedding from N(0, 1), the rest with torch's default bounds,
        all drawn from ``generator`` on the CPU; the statistics stay."""
        with torch.no_grad():
            self.embedding.weight.copy_(torch.randn(self.embedding.weight.shape,
                                                    generator=generator))
        self.lstm.reset_parameters(generator)
        for block in self.decoder:
            block.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.projection.in_features)
        uniform_(self.projection.weight, bound, generator)
        uniform_(self.projection.bias, bound, generator)

    def forward(self, aligntext: torch.Tensor, aligntext_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """``([B, L], [B]) -> (hasf0 [B, T], f0 [B, T], logspc [B, T, S],
        hascodeap [B, T, C], codeap [B, T, C])``; in training mode the
        biLSTM applies its inter-layer dropout, drawing from ``generator``."""
        x = self.embedding(aligntext.long())
        x = self.lstm(x, aligntext_len, generator)
        x = self.projection(self.decoder(x))
        f, s, c = self.f0_size, self.logspc_size, self.codeap_size
        return (x[:, :, 0], x[:, :, f], x[:, :, 2 * f:2 * f + s],
                x[:, :, 2 * f + s:2 * f + s + c], x[:, :, 2 * f + s + c:])

    def output_length(self, aligntext_len):
        return conv_stack_output_length(self.decoder_settings, aligntext_len)

    @torch.inference_mode()
    def predict(self, aligntext: torch.Tensor,
                aligntext_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Unnormalized ``(f0, logspc or mcep, codeap)``, with f0 and codeap
        zero where their ``has*`` logits are below 0."""
        hasf0, f0, logspc, hascodeap, codeap = self(aligntext, aligntext_len)
        f0, logspc, codeap = self.norm.unnormalize(f0, logspc, codeap)
        f0 = torch.where(hasf0 < 0, 0.0, f0)
        codeap = torch.where(hascodeap < 0, 0.0, codeap)
        return f0, logspc, codeap

    def compute_loss(self, f0: torch.Tensor, f0_len: torch.Tensor, logspc: torch.Tensor,
                     codeap: torch.Tensor, aligntext: torch.Tensor, aligntext_len: torch.Tensor,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> WORLDLossValues:
        """Per-stream losses of a WORLD batch (``f0 [B, T]``, ``logspc
        [B, T, S]``, ``codeap [B, T, C]`` raw, masked by ``f0_len``). The
        voicing targets ``f0 >= 30`` and ``codeap < -0.2`` come from the
        raw features, the regression targets are normalized; prediction
        (``2 L`` frames) and targets (the 64-frame time bucket) are cropped
        to their common length. ``deterministic`` is the JAX signature's;
        dropout follows the module's training mode."""
        del deterministic
        hasf0 = (f0 >= 30.0).to(torch.float32)
        hascodeap = (codeap < -0.2).to(torch.float32)
        f0, logspc, codeap = self.norm.normalize(f0, logspc, codeap)
        hasf0_logits, f0_hat, logspc_hat, hascodeap_logits, codeap_hat = self(
            aligntext, aligntext_len, generator)
        return world_loss_v2(f0_len, hasf0_logits, f0_hat, logspc_hat, hascodeap_logits,
                             codeap_hat, hasf0, f0, logspc, hascodeap, codeap)

    @staticmethod
    def total_loss(values: WORLDLossValues, logspc_weight: float = 5.0) -> torch.Tensor:
        """The weighted sum the optimizer sees (reference _tts_v2.py:103-107)."""
        return (values.hasf0 + values.f0 + values.logspc * logspc_weight + values.hascodeap
                + values.codeap)
