"""v1 ASR model: AudioToTextCTC (the deprecated family).

Port of ``voice100_tpu/models/asr_v1.py`` (the reference's
voice100/models/asr.py:27-196): a MobileNetV2-style stack of nine 1-D
inverted residual blocks (expand x4, depthwise kernels 11..83, stride 2
on the first block) and a 1x1 conv decoder behind dropout 0.2; the CTC
loss through the lattice kernels (4 and 5 on the card); an optional
per-utterance masked mean/std normalization.

The blocks run on ``[B, C, T]`` between the model's ``[B, T, C]`` input
and output, in float32 under every compute dtype, as flax's ``nn.Conv``
without a ``dtype`` does. Their BatchNorms are
:class:`~voice100_tpu_torch.models.layers.BatchNorm`, with flax's
statistics (padding positions included). Names follow the torch
reference (``encoder.layers.{i}.conv.{0,1}.{0,1}``, ``conv.2``,
``conv.3``, ``decoder.layers.1``), so state dicts carry across
(``tools/weights.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import default_generator, resolve_device
from ..ops.augment import apply_augment, draw_augment
from ..ops.ctc_cuda import ctc_loss_cuda
from ..ops.mask import sequence_mask
from .layers import BatchNorm, dropout, reset_conv

__all__ = ["AudioToTextCTC", "ConvVoiceEncoder", "InvertedResidual", "ConvBNActivate"]

# (out_channels of hidden_size // 2, hidden_size or embed_size; kernel,
# stride, residual), voice100/models/asr.py:62-82
_ENCODER_SPECS = (("half", 11, 2, False), ("half", 19, 1, True), ("half", 27, 1, True),
                  ("half", 35, 1, True), ("hidden", 51, 1, False), ("hidden", 59, 1, True),
                  ("hidden", 67, 1, True), ("hidden", 75, 1, True), ("out", 83, 1, False))


class ConvBNActivate(nn.Sequential):
    """Conv1d (no bias, padding ``(k - 1) // 2 * dilation``) + BatchNorm +
    ReLU6 as a clip to [0, 6], on ``[B, C, T]`` (reference asr.py:27-37;
    children ``0`` and ``1``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, device=None) -> None:
        device = resolve_device(device)
        padding = (kernel_size - 1) // 2 * dilation
        super().__init__(
            nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                      dilation=dilation, groups=groups, bias=False, device=device),
            BatchNorm(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self[1](self[0](x)), 0.0, 6.0)


class InvertedResidual(nn.Module):
    """Pointwise expand (x ``expand_ratio``) -> depthwise ``kernel_size``
    -> pointwise linear + BatchNorm, with an optional residual, on
    ``[B, C, T]`` (reference asr.py:40-59; ``conv.0`` to ``conv.3``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 expand_ratio: int = 4, use_residual: bool = True, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        hidden = in_channels * expand_ratio
        self.use_residual = use_residual
        self.conv = nn.Sequential(
            ConvBNActivate(in_channels, hidden, 1, device=device),
            ConvBNActivate(hidden, hidden, kernel_size, stride=stride, groups=hidden,
                           device=device),
            nn.Conv1d(hidden, out_channels, 1, bias=False, device=device),
            BatchNorm(out_channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for module in self.conv.modules():
            if isinstance(module, nn.Conv1d):
                reset_conv(module, generator)
            elif isinstance(module, BatchNorm):
                module.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_residual else y


class ConvVoiceEncoder(nn.Module):
    """The nine inverted residual blocks (reference asr.py:62-82) as
    ``layers``, ``[B, C, T] -> [B, out_channels, (T + 1) // 2]``."""

    def __init__(self, in_channels: int, out_channels: int, hidden_size: int,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        widths = {"half": hidden_size // 2, "hidden": hidden_size, "out": out_channels}
        blocks = []
        for width, kernel, stride, residual in _ENCODER_SPECS:
            blocks.append(InvertedResidual(in_channels, widths[width], kernel, stride=stride,
                                           use_residual=residual, device=device))
            in_channels = widths[width]
        self.layers = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)

    @staticmethod
    def output_length(length):
        return (length + 1) // 2


class _Decoder(nn.Module):
    """Dropout 0.2 and the 1x1 conv to the vocabulary (reference
    asr.py:84-96, ``decoder.layers.{0,1}``)."""

    def __init__(self, in_channels: int, vocab_size: int, device=None) -> None:
        super().__init__()
        self.layers = nn.Sequential(nn.Dropout(0.2),
                                    nn.Conv1d(in_channels, vocab_size, 1, device=device))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = dropout(x, self.layers[0].p, self.training, generator)
        return self.layers[1](x)


class AudioToTextCTC(nn.Module):
    """``[B, T, audio_size]`` log-mel -> ``[B, (T + 1) // 2, vocab_size]``
    logits, on ``device`` (default ``cuda``) with weights drawn from
    ``generator``. ``learning_rate`` and ``weight_decay`` are the AdamW
    settings of the training task (``training/tasks.py``)."""

    def __init__(self, audio_size: int, vocab_size: int, embed_size: int = 512,
                 hidden_size: int = 512, learning_rate: float = 1e-3, weight_decay: float = 4e-5,
                 do_normalize: bool = False, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.audio_size = audio_size
        self.vocab_size = vocab_size
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.do_normalize = do_normalize
        self.encoder = ConvVoiceEncoder(audio_size, embed_size, hidden_size, device=device)
        self.decoder = _Decoder(embed_size, vocab_size, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default bounds for every conv, BatchNorm at 1 and 0 with
        running averages 0 and 1; drawn from ``generator`` on the CPU."""
        for block in self.encoder.layers:
            block.reset_parameters(generator)
        reset_conv(self.decoder.layers[1], generator)

    def forward(self, audio: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, T, audio_size] -> [B, (T + 1) // 2, vocab_size]``; in
        training mode the BatchNorms take the batch's statistics and the
        dropout draws from ``generator``."""
        x = self.encoder(audio.transpose(1, 2))
        return self.decoder(x, generator).transpose(1, 2)

    def output_length(self, audio_len):
        return ConvVoiceEncoder.output_length(audio_len)

    def normalize(self, audio: torch.Tensor, audio_len: torch.Tensor) -> torch.Tensor:
        """Masked per-utterance mean and std (reference asr.py:124-131)."""
        mask = sequence_mask(audio_len.to(audio.device), audio.shape[1], audio.dtype)[:, :, None]
        denom = mask.sum(dim=1, keepdim=True)
        mean = (audio * mask).sum(dim=1, keepdim=True) / denom
        audio = (audio - mean) * mask
        std = torch.sqrt((audio ** 2).sum(dim=1, keepdim=True) / denom)
        return audio / (std + 1e-15) * mask

    def compute_loss(self, audio: torch.Tensor, audio_len: torch.Tensor, text: torch.Tensor,
                     text_len: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CTC training loss: spectrogram augmentation unless
        ``deterministic``, the normalization where ``do_normalize``, the
        model, log-softmax, and the lattice kernels over the logit lengths.
        The BatchNorms and the dropout follow the module's training mode.
        Draws come from ``generator`` (the device's default if None)."""
        if generator is None:
            generator = default_generator(audio.device)
        if not deterministic:
            audio, audio_len = apply_augment(audio, audio_len,
                                             draw_augment(generator, *audio.shape))
        if self.do_normalize:
            audio = self.normalize(audio, audio_len)
        logits = self(audio, generator)
        log_probs = torch.log_softmax(logits, dim=-1)
        return ctc_loss_cuda(log_probs, text, self.output_length(audio_len), text_len)
