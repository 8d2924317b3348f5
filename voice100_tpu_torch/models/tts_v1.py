"""v1 TTS models (the deprecated family).

Port of ``voice100_tpu/models/tts_v1.py`` (the reference's
voice100/models/tts.py): ``TextToAlignTextModel`` (an embedding, four
inverted residual blocks and a 1x1 conv to the log-duration pair),
``AlignTextToAudioModel`` (an embedding and :class:`VoiceDecoder`) and
``AlignTextToAudioMultiTaskModel`` (an embedding and
:class:`VoiceMultiTaskDecoder`, with a phone head beside the WORLD
head), and :func:`expand_alignment_v1`. The multi-task model is
constructible, as in the JAX package (the reference's constructor passes
its WORLD loss an argument it does not take; ``tts_v1.py:7-10``).

The decoders upsample time x2 with a ``ConvTranspose1d(k=5, stride=2,
padding=2)``: ``2 T - 1`` frames, which is JAX's ``conv_general_dilated``
with ``lhs_dilation=2``, padding (2, 2) and the kernel flipped in time
(``tools/weights.py``). It runs under cuDNN's deterministic algorithms
(:func:`~voice100_tpu_torch.models.layers.deterministic_cudnn`), as the
v2 decoder's does. Names follow the torch reference (``embedding``,
``layers.{i}``, ``decoder.layers.{i}``, ``decoder.layer{1,2,3}``,
``norm.*``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.mask import sequence_mask
from ..parallel.mesh import global_sum
from .asr_v1 import InvertedResidual
from .layers import BatchNorm, WORLDNorm, deterministic_cudnn, reset_conv
from .losses import duration_loss, mel_logspc_weights, world_loss_v1

__all__ = ["TextToAlignTextModel", "AlignTextToAudioModel", "AlignTextToAudioMultiTaskModel",
           "VoiceDecoder", "VoiceMultiTaskDecoder", "expand_alignment_v1"]


def _reset(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every conv of ``module`` from torch's default bounds (drawn from
    ``generator``, in module order), every BatchNorm at its start."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            reset_conv(m, generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


def _reset_embedding(embedding: nn.Embedding, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        embedding.weight.copy_(torch.randn(embedding.weight.shape, generator=generator))


def _upsample(conv: nn.ConvTranspose1d, x: torch.Tensor) -> torch.Tensor:
    with deterministic_cudnn():
        return conv(x)


class VoiceDecoder(nn.Module):
    """Four inverted residual blocks (k 65, 33, 17, 11), the x2 transposed
    conv to ``hidden_size // 2``, three blocks (k 33, 11, 7) and a 1x1
    conv, on ``[B, C, T] -> [B, out_channels, 2 T - 1]`` (reference
    tts.py:13-29, ``layers.0-8``)."""

    def __init__(self, hidden_size: int, out_channels: int, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        half = hidden_size // 2
        self.layers = nn.Sequential(
            *(InvertedResidual(hidden_size, hidden_size, k, device=device)
              for k in (65, 33, 17, 11)),
            nn.ConvTranspose1d(hidden_size, half, 5, stride=2, padding=2, device=device),
            *(InvertedResidual(half, half, k, device=device) for k in (33, 11, 7)),
            nn.Conv1d(half, out_channels, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = _upsample(layer, x) if isinstance(layer, nn.ConvTranspose1d) else layer(x)
        return x


class VoiceMultiTaskDecoder(nn.Module):
    """The shared trunk ``layer1`` (six blocks, k 65, 47, 33, 17, 11, 7),
    the phone head ``layer3`` (a 1x1 conv at the trunk's rate) and the
    WORLD head ``layer2`` (the x2 transposed conv, two blocks k 11 and 7,
    a 1x1 conv), on ``[B, C, T] -> ([B, out, 2 T - 1], [B, secondary,
    T])`` (reference tts.py:32-54)."""

    def __init__(self, hidden_size: int, out_channels: int, secondary_channels: int,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        half = hidden_size // 2
        self.layer1 = nn.Sequential(*(InvertedResidual(hidden_size, hidden_size, k, device=device)
                                      for k in (65, 47, 33, 17, 11, 7)))
        self.layer2 = nn.Sequential(
            nn.ConvTranspose1d(hidden_size, half, 5, stride=2, padding=2, device=device),
            *(InvertedResidual(half, half, k, device=device) for k in (11, 7)),
            nn.Conv1d(half, out_channels, 1, device=device))
        self.layer3 = nn.Conv1d(hidden_size, secondary_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.layer1(x)
        y = self.layer3(x)
        x = _upsample(self.layer2[0], x)
        for layer in self.layer2[1:]:
            x = layer(x)
        return x, y


class TextToAlignTextModel(nn.Module):
    """v1 duration model (reference tts.py:67-149): ``[B, L]`` ids ->
    ``[B, L, 2]`` log-durations, on ``device`` (default ``cuda``) with
    weights drawn from ``generator``."""

    def __init__(self, vocab_size: int, hidden_size: int = 512, learning_rate: float = 1e-3,
                 device=None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.learning_rate = learning_rate
        self.embedding = nn.Embedding(vocab_size, hidden_size, device=device)
        self.layers = nn.Sequential(
            *(InvertedResidual(hidden_size, hidden_size, k, device=device)
              for k in (5, 11, 17, 29)),
            nn.Conv1d(hidden_size, 2, 1, device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Embedding from N(0, 1), the convs with torch's default bounds,
        drawn from ``generator`` on the CPU."""
        _reset_embedding(self.embedding, generator)
        _reset(self.layers, generator)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        x = self.embedding(text.long()).transpose(1, 2)
        return self.layers(x).transpose(1, 2)

    def compute_loss(self, text: torch.Tensor, text_len: torch.Tensor, align: torch.Tensor,
                     align_len: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Masked L1 on ``log(1 + frames)`` over the first ``min(L, L')``
        tokens, the flat ``align [B, 2L(+1)]`` read as ``[B, L', 2]``
        pairs after its trailing odd slot is dropped (``tts_v1.py:77-85``).
        ``deterministic`` is the JAX signature's; the BatchNorms follow
        the module's training mode."""
        del align_len, deterministic, generator
        batch = align.shape[0]
        usable = (align.shape[1] - 1) // 2 * 2
        pairs = align[:, :usable].reshape(batch, -1, 2)
        pred = self(text)
        n = min(pred.shape[1], pairs.shape[1])
        return duration_loss(pred[:, :n], pairs[:, :n], text[:, :n], text_len)

    @torch.inference_mode()
    def predict(self, text: torch.Tensor) -> torch.Tensor:
        """Durations in frames, ``exp(y) - 1`` (may be negative)."""
        return torch.exp(self(text)) - 1.0


def expand_alignment_v1(text, align, text_len, out_len: int, head: int = 5) -> torch.Tensor:
    """The v1 duration expansion (reference tts.py:89-110,
    ``voice100_tpu/models/tts_v1.py:88-114``) of one text: a float32
    cursor from ``head`` adds each valid token's two durations in token
    order; the token covers ``[round(t + a0), round(t + a0 + a1))``,
    rounding half to even, and a span with ``s == e`` becomes ``[s,
    max(0, e + 1))``. There is no monotone cursor: later tokens overwrite
    earlier frames. Tokens at or past ``text_len`` write nothing and do
    not move the cursor. ``text [L]`` and ``align [L, 2]`` are tensors or
    arrays; returns ``[out_len]`` ids of ``text``'s dtype, on its device
    when it is a tensor (the loop runs on the host)."""
    device = text.device if isinstance(text, torch.Tensor) else torch.device("cpu")
    ids = text.cpu().numpy() if isinstance(text, torch.Tensor) else np.asarray(text)
    a = (align.cpu().numpy() if isinstance(align, torch.Tensor) else np.asarray(align))
    a = a.astype(np.float32)
    out = np.zeros(out_len, ids.dtype)
    t = np.float32(head)
    for i in range(min(int(text_len), len(ids))):
        t = np.float32(t + a[i, 0])
        s = int(np.round(t))
        t = np.float32(t + a[i, 1])
        e = int(np.round(t))
        if s == e:
            e = max(0, e + 1)
        if e > max(s, 0):
            out[max(s, 0):e] = ids[i]
    return torch.from_numpy(out).to(device)


class AlignTextToAudioModel(nn.Module):
    """v1 acoustic model (reference tts.py:152-262): ``[B, L]`` aligned
    ids -> ``(hasf0 [B, 2L - 1], f0, logspc [B, 2L - 1, S], codeap [B,
    2L - 1, 1])``, S = 25 (``use_mcep``) or ``n_fft // 2 + 1``; on
    ``device`` (default ``cuda``) with weights drawn from ``generator``.
    The WORLD statistics are the ``norm`` buffers."""

    def __init__(self, vocab_size: int, hidden_size: int = 512, use_mcep: bool = False,
                 learning_rate: float = 1e-3, sample_rate: int = 16000, n_fft: int = 512,
                 device=None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.use_mcep = use_mcep
        self.learning_rate = learning_rate
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.embedding = nn.Embedding(vocab_size, hidden_size, device=device)
        self.decoder = self._decoder(device)
        self.norm = WORLDNorm(self.logspc_size, self.codeap_size, device=device)
        self.reset_parameters(generator)

    def _decoder(self, device) -> nn.Module:
        return VoiceDecoder(self.hidden_size, self.audio_size, device=device)

    @property
    def logspc_size(self) -> int:
        return 25 if self.use_mcep else self.n_fft // 2 + 1

    @property
    def codeap_size(self) -> int:
        return 1

    @property
    def audio_size(self) -> int:
        """hasf0 + f0 + logspc + codeap."""
        return 2 + self.logspc_size + self.codeap_size

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Embedding from N(0, 1), the convs with torch's default bounds,
        drawn from ``generator`` on the CPU; the statistics stay."""
        _reset_embedding(self.embedding, generator)
        _reset(self.decoder, generator)

    def _split(self, x: torch.Tensor):
        x = x.transpose(1, 2)
        s, c = self.logspc_size, self.codeap_size
        return x[:, :, 0], x[:, :, 1], x[:, :, 2:2 + s], x[:, :, 2 + s:2 + s + c]

    def forward(self, aligntext: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self._split(self.decoder(self.embedding(aligntext.long()).transpose(1, 2)))

    def _logspc_weights(self, device) -> Optional[torch.Tensor]:
        if self.use_mcep:
            return None
        return torch.from_numpy(mel_logspc_weights(self.sample_rate, self.n_fft)).to(device)

    @torch.inference_mode()
    def predict(self, aligntext: torch.Tensor):
        """Unnormalized ``(f0, logspc, codeap)``, f0 zero where the voicing
        logit is below 0."""
        hasf0, f0, logspc, codeap = self(aligntext)
        f0, logspc, codeap = self.norm.unnormalize(f0, logspc, codeap)
        return torch.where(hasf0 < 0, 0.0, f0), logspc, codeap

    def compute_loss(self, f0: torch.Tensor, f0_len: torch.Tensor, logspc: torch.Tensor,
                     codeap: torch.Tensor, aligntext: torch.Tensor, aligntext_len: torch.Tensor,
                     deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """``(hasf0, f0, logspc, codeap)`` losses of :func:`world_loss_v1`:
        the voicing target ``f0 >= 30`` from the raw f0, the regression
        targets normalized, the spectrum weighted by the mel weights unless
        ``use_mcep``. ``deterministic`` is the JAX signature's; the
        BatchNorms follow the module's training mode."""
        del aligntext_len, deterministic, generator
        hasf0 = (f0 >= 30.0).to(torch.float32)
        f0, logspc, codeap = self.norm.normalize(f0, logspc, codeap)
        hasf0_logits, f0_hat, logspc_hat, codeap_hat = self(aligntext)
        return world_loss_v1(f0_len, hasf0_logits, f0_hat, logspc_hat, codeap_hat, hasf0, f0,
                             logspc, codeap, logspc_weights=self._logspc_weights(f0.device))


class AlignTextToAudioMultiTaskModel(AlignTextToAudioModel):
    """v1 multi-task acoustic model (reference tts.py:265-383): the WORLD
    streams of :class:`AlignTextToAudioModel` from the x2 head, and
    ``[B, L, target_vocab_size]`` phone logits at the aligned text's
    rate."""

    def __init__(self, vocab_size: int, target_vocab_size: int, hidden_size: int = 512,
                 use_mcep: bool = False, learning_rate: float = 1e-3, sample_rate: int = 16000,
                 n_fft: int = 512, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        self.target_vocab_size = target_vocab_size
        super().__init__(vocab_size, hidden_size=hidden_size, use_mcep=use_mcep,
                         learning_rate=learning_rate, sample_rate=sample_rate, n_fft=n_fft,
                         device=device, generator=generator)

    def _decoder(self, device) -> nn.Module:
        return VoiceMultiTaskDecoder(self.hidden_size, self.audio_size, self.target_vocab_size,
                                     device=device)

    def forward(self, aligntext: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x, y = self.decoder(self.embedding(aligntext.long()).transpose(1, 2))
        return (*self._split(x), y.transpose(1, 2))

    @torch.inference_mode()
    def predict(self, aligntext: torch.Tensor):
        """``(f0, logspc, codeap, phone logits)``, the WORLD streams as
        :meth:`AlignTextToAudioModel.predict` gives them."""
        hasf0, f0, logspc, codeap, logits = self(aligntext)
        f0, logspc, codeap = self.norm.unnormalize(f0, logspc, codeap)
        return torch.where(hasf0 < 0, 0.0, f0), logspc, codeap, logits

    def compute_loss(self, f0: torch.Tensor, f0_len: torch.Tensor, logspc: torch.Tensor,
                     codeap: torch.Tensor, aligntext: torch.Tensor, aligntext_len: torch.Tensor,
                     phonetext: torch.Tensor, phonetext_len: torch.Tensor,
                     deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """The four WORLD losses and the phone loss: the NLL of the phone
        targets under the phone logits over ``n = min(T_logits,
        T_phone)`` positions, masked by ``phonetext_len`` and divided by
        the mask's sum (at least 1; the global batch's inside
        :func:`~voice100_tpu_torch.parallel.mesh.global_batch`)."""
        del aligntext_len, deterministic, generator
        hasf0 = (f0 >= 30.0).to(torch.float32)
        f0n, logspcn, codeapn = self.norm.normalize(f0, logspc, codeap)
        hasf0_logits, f0_hat, logspc_hat, codeap_hat, target_logits = self(aligntext)
        losses = world_loss_v1(f0_len, hasf0_logits, f0_hat, logspc_hat, codeap_hat, hasf0, f0n,
                               logspcn, codeapn, logspc_weights=self._logspc_weights(f0.device))
        n = min(target_logits.shape[1], phonetext.shape[1])
        logp = F.log_softmax(target_logits[:, :n], dim=-1)
        nll = -torch.gather(logp, 2, phonetext[:, :n, None].long())[:, :, 0]
        mask = sequence_mask(phonetext_len.to(nll.device), n, dtype=nll.dtype)
        phone_loss = (nll * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)
        return (*losses, phone_loss)
