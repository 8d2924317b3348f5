"""Conformer-CTC (NVIDIA NeMo's ``conformer_ctc_bpe.yaml``, Gulati et al.,
arXiv:2005.08100): a conv2d subsampling, relative-position encodings,
Conformer blocks and a 1x1 decoder to the vocabulary, trained with CTC.

The JAX package has no counterpart: this model is the port's own. It
follows NeMo's ``ConvSubsampling(striding)``, ``RelPositionalEncoding``
(x-scaling by ``sqrt(d_model)``), ``ConformerLayer``,
``RelPositionMultiHeadAttention`` (untied per-head biases) and
``ConformerConvolution`` (batch norm), with these differences:

* the blank is id 0 (NeMo puts it last), as the CTC lattice kernels take
  it: a permutation of the decoder's output rows;
* the pointwise convolutions and the decoder are ``nn.Linear`` on
  ``[B, T, C]`` (NeMo's ``Conv1d`` with kernel 1: the same function, its
  weight without the kernel axis);
* ``pos_bias_u``/``pos_bias_v`` start at zero as in NeMo, and the
  benchmark and tests seed them;
* SpecAugment draws on the device (:func:`~voice100_tpu_torch.ops.augment.draw_spec_augment`),
  with NeMo's distribution.

Each block computes ``x + FFN/2``, ``+ RelMHSA``, ``+ ConvModule``,
``+ FFN/2``, then a LayerNorm; every sub-block's output passes through
dropout before its residual add. Padded frames: the attention masks
padded keys and zeroes padded query rows, the conv module zeroes padded
frames before its depthwise conv, and the BatchNorm takes its training
statistics over all ``B T'`` frames, the padded ones too (NeMo's).

Dropout masks are drawn from the step's generator with
:func:`~voice100_tpu_torch.ops.relpos_attention.keep_mask` (one uint8
``bernoulli_`` a tensor; a rate of 0 draws nothing), in this order, so
that a reference can replay them: SpecAugment's uniforms
(``compute_loss``), the pre-encoder dropout ``[B, T', d]``; then each
block in turn: the first FFN's inner ``[B, T', 4d]`` and output
``[B, T', d]`` masks, the attention probabilities ``[B, H, T', T']``, the
attention output, the conv module output, the second FFN's inner and
output masks.

On CUDA the attention runs through kernel 9
(``ops/relpos_attention_cuda.py``) forward and backward, and the CTC loss
through kernels 4-5. The host spans ``conformer.subsample``,
``conformer.attention``, ``conformer.conv_module`` and ``conformer.ffn``
(``utils/profiling.py``) time each part of the forward, summed over the
blocks of a step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_generator, resolve_device
from ..ops.augment import apply_spec_augment, draw_spec_augment
from ..ops.ctc_cuda import ctc_loss_cuda
from ..ops.relpos_attention import dropout_keep, keep_mask
from ..ops.relpos_attention_cuda import relpos_attention_cuda
from ..utils.profiling import span
from .layers import uniform_

__all__ = ["ConformerCTC", "rel_positions", "subsampled_length", "noam_lr"]


def subsampled_length(lengths, n_convs: int = 2):
    """NeMo's ``calc_length`` for kernel 3, stride 2, padding 1, applied
    once a conv: ``(L + 2 - 3) // 2 + 1``."""
    for _ in range(n_convs):
        lengths = (lengths - 1) // 2 + 1
    return lengths


def rel_positions(time: int, d_model: int, device) -> torch.Tensor:
    """Sinusoidal encodings of the relative positions ``T-1 .. -(T-1)``,
    ``[2T - 1, d_model]`` (NeMo's ``RelPositionalEncoding``)."""
    pos = torch.arange(time - 1, -time, -1, dtype=torch.float32, device=device).unsqueeze(1)
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(2 * time - 1, d_model, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def noam_lr(step: int, d_model: int, peak_lr: float, warmup_steps: int, min_lr: float) -> float:
    """NeMo's ``NoamAnnealing`` at optimizer step ``step`` (at least 1):
    ``peak_lr d^-1/2 min(s^-1/2, s w^-3/2)``, floored at ``min_lr`` past
    the warm-up."""
    s = max(1, int(step))
    lr = peak_lr * d_model ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return max(lr, min_lr) if s > warmup_steps else lr


def _drop(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout with a mask of :func:`keep_mask` (none without a generator
    or at a rate of 0)."""
    if generator is None or p <= 0.0:
        return x
    return dropout_keep(x, keep_mask(x.shape, p, generator, x.device), p)


class ConvSubsampling(nn.Module):
    """NeMo's ``striding`` subsampling: ``n_convs`` of Conv2d(k=3, s=2,
    p=1) with ReLU over ``[B, 1, T, F]``, then a Linear of the channels
    and the remaining frequency bins to ``d_model``."""

    def __init__(self, feat_in: int, d_model: int, n_convs: int, device=None) -> None:
        super().__init__()
        channels = [1] + [d_model] * n_convs
        self.conv = nn.ModuleList(
            nn.Conv2d(channels[i], channels[i + 1], 3, stride=2, padding=1, device=device)
            for i in range(n_convs))
        self.n_convs = n_convs
        self.out = nn.Linear(d_model * int(subsampled_length(feat_in, n_convs)), d_model,
                             device=device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        x = x.unsqueeze(1)
        for conv in self.conv:
            x = torch.relu(conv(x))
        b, c, t, f = x.shape
        return self.out(x.transpose(1, 2).reshape(b, t, c * f)), subsampled_length(
            lengths, self.n_convs)


class FeedForward(nn.Module):
    """Linear(d -> e d), Swish, dropout, Linear(e d -> d)."""

    def __init__(self, d_model: int, expansion: int, dropout: float, device=None) -> None:
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_model * expansion, device=device)
        self.linear2 = nn.Linear(d_model * expansion, d_model, device=device)
        self.dropout = dropout

    def forward(self, x, generator):
        return self.linear2(_drop(F.silu(self.linear1(x)), self.dropout, generator))


class RelPositionMultiHeadAttention(nn.Module):
    """Transformer-XL attention with untied per-head biases ``u`` and
    ``v`` (``pos_bias_u``, ``pos_bias_v``, ``[H, D]``) over the projected
    positions ``linear_pos(pe)``; the core is kernel 9
    (:func:`~voice100_tpu_torch.ops.relpos_attention_cuda.relpos_attention_cuda`;
    its plain version on the CPU)."""

    def __init__(self, d_model: int, n_heads: int, dropout_att: float, device=None) -> None:
        super().__init__()
        self.heads, self.head_dim = n_heads, d_model // n_heads
        self.linear_q = nn.Linear(d_model, d_model, device=device)
        self.linear_k = nn.Linear(d_model, d_model, device=device)
        self.linear_v = nn.Linear(d_model, d_model, device=device)
        self.linear_out = nn.Linear(d_model, d_model, device=device)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, self.head_dim, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, self.head_dim, device=device))
        self.dropout_att = dropout_att

    def forward(self, x, lengths, pos_emb, generator):
        b, t, _ = x.shape
        shape = (b, t, self.heads, self.head_dim)
        q = self.linear_q(x).view(shape)
        k = self.linear_k(x).view(shape)
        v = self.linear_v(x).view(shape)
        p = self.linear_pos(pos_emb).view(2 * t - 1, self.heads, self.head_dim)
        keep = None
        if generator is not None and self.dropout_att > 0.0:
            keep = keep_mask((b, self.heads, t, t), self.dropout_att, generator, x.device)
        o = relpos_attention_cuda(q, k, v, p, self.pos_bias_u, self.pos_bias_v, lengths, keep,
                                  self.dropout_att)
        return self.linear_out(o.reshape(b, t, self.heads * self.head_dim))


class ConvModule(nn.Module):
    """Pointwise 2d (a Linear), GLU, padded frames zeroed, depthwise conv
    (kernel k, padding (k-1)/2), BatchNorm1d, Swish, pointwise d."""

    def __init__(self, d_model: int, kernel_size: int, device=None) -> None:
        super().__init__()
        self.pointwise_conv1 = nn.Linear(d_model, 2 * d_model, device=device)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel_size,
                                        padding=(kernel_size - 1) // 2, groups=d_model,
                                        device=device)
        self.batch_norm = nn.BatchNorm1d(d_model, device=device)
        self.pointwise_conv2 = nn.Linear(d_model, d_model, device=device)

    def forward(self, x, valid):
        x = F.glu(self.pointwise_conv1(x), dim=-1)
        x = x.masked_fill(~valid[:, :, None], 0.0)
        x = F.silu(self.batch_norm(self.depthwise_conv(x.transpose(1, 2))))
        return self.pointwise_conv2(x.transpose(1, 2))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, expansion: int, kernel_size: int,
                 dropout: float, dropout_att: float, device=None) -> None:
        super().__init__()
        self.norm_feed_forward1 = nn.LayerNorm(d_model, device=device)
        self.feed_forward1 = FeedForward(d_model, expansion, dropout, device)
        self.norm_self_att = nn.LayerNorm(d_model, device=device)
        self.self_attn = RelPositionMultiHeadAttention(d_model, n_heads, dropout_att, device)
        self.norm_conv = nn.LayerNorm(d_model, device=device)
        self.conv = ConvModule(d_model, kernel_size, device)
        self.norm_feed_forward2 = nn.LayerNorm(d_model, device=device)
        self.feed_forward2 = FeedForward(d_model, expansion, dropout, device)
        self.norm_out = nn.LayerNorm(d_model, device=device)
        self.dropout = dropout

    def forward(self, x, lengths, valid, pos_emb, generator):
        p = self.dropout
        with span("conformer.ffn"):
            x = x + 0.5 * _drop(self.feed_forward1(self.norm_feed_forward1(x), generator), p,
                                generator)
        with span("conformer.attention"):
            x = x + _drop(self.self_attn(self.norm_self_att(x), lengths, pos_emb, generator), p,
                          generator)
        with span("conformer.conv_module"):
            x = x + _drop(self.conv(self.norm_conv(x), valid), p, generator)
        with span("conformer.ffn"):
            x = x + 0.5 * _drop(self.feed_forward2(self.norm_feed_forward2(x), generator), p,
                                generator)
        return self.norm_out(x)


class ConformerCTC(nn.Module):
    """``[B, T, audio_size]`` features -> ``[B, T', vocab_size]`` logits
    (blank 0), ``T' = `` :func:`subsampled_length` ``(T)``.

    Built on ``device`` (default ``cuda``; see :func:`resolve_device`)
    with weights drawn from ``generator`` (torch's default bounds; the
    norms at 1 and 0, the position biases at 0). ``weight_decay``,
    ``warmup_steps``, ``peak_lr`` and ``min_lr`` are the AdamW and Noam
    settings the training task reads (:func:`noam_lr`).
    """

    def __init__(self, audio_size: int = 80, vocab_size: int = 129, d_model: int = 512,
                 n_heads: int = 8, n_layers: int = 18, ff_expansion_factor: int = 4,
                 conv_kernel_size: int = 31, subsampling_factor: int = 4, dropout: float = 0.1,
                 dropout_att: float = 0.1, dropout_pre_encoder: float = 0.1,
                 weight_decay: float = 1e-3, warmup_steps: int = 10000, peak_lr: float = 2.0,
                 min_lr: float = 1e-6, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        n_convs = int(round(math.log2(subsampling_factor)))
        if 2 ** n_convs != subsampling_factor or n_convs < 1:
            raise ValueError(f"subsampling_factor {subsampling_factor}: a power of two >= 2")
        self.audio_size, self.vocab_size, self.d_model = audio_size, vocab_size, d_model
        self.dropout_pre_encoder = dropout_pre_encoder
        self.weight_decay, self.warmup_steps = weight_decay, warmup_steps
        self.peak_lr, self.min_lr = peak_lr, min_lr
        self.xscale = math.sqrt(d_model)
        self.pre_encode = ConvSubsampling(audio_size, d_model, n_convs, device)
        self.layers = nn.ModuleList(
            ConformerBlock(d_model, n_heads, ff_expansion_factor, conv_kernel_size, dropout,
                           dropout_att, device) for _ in range(n_layers))
        self.decoder = nn.Linear(d_model, vocab_size, device=device)
        self.reset_parameters(generator)

    @property
    def learning_rate(self) -> float:
        """The Noam rate at step 1 (the optimizer's initial rate)."""
        return self.lr_at(1)

    def lr_at(self, step: int) -> float:
        return noam_lr(step, self.d_model, self.peak_lr, self.warmup_steps, self.min_lr)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default bounds, drawn from ``generator`` on the CPU:
        ``1/sqrt(fan_in)`` for every linear and conv weight and bias; the
        LayerNorms and BatchNorms at 1 and 0; the position biases at 0."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = module.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                uniform_(module.weight, bound, generator)
                if module.bias is not None:
                    uniform_(module.bias, bound, generator)
            elif isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)):
                module.reset_parameters()
            elif isinstance(module, RelPositionMultiHeadAttention):
                module.pos_bias_u.zero_()
                module.pos_bias_v.zero_()

    def forward(self, audio: torch.Tensor, audio_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``([B, T, audio_size], [B]) -> ([B, T', vocab_size], [B])``. In
        training mode the dropout masks are drawn from ``generator`` (the
        device's default generator if None); in eval mode none is drawn."""
        if not self.training:
            generator = None
        elif generator is None:
            generator = default_generator(audio.device)
        with span("conformer.subsample"):
            x, x_len = self.pre_encode(audio, audio_len)
            time = x.shape[1]
            pos_emb = rel_positions(time, self.d_model, x.device)
            x = _drop(x * self.xscale, self.dropout_pre_encoder, generator)
            valid = torch.arange(time, device=x.device)[None, :] < x_len[:, None]
        for layer in self.layers:
            x = layer(x, x_len, valid, pos_emb, generator)
        return self.decoder(x), x_len

    def compute_loss(self, audio: torch.Tensor, audio_len: torch.Tensor, text: torch.Tensor,
                     text_len: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CTC loss with NeMo's ``mean_batch`` reduction (the batch mean of
        each row's negative log-likelihood, not divided by its target
        length; infeasible rows count 0): SpecAugment unless
        ``deterministic``, the model, log-softmax, kernels 4-5 over the
        subsampled lengths."""
        if not deterministic:
            if generator is None:
                generator = default_generator(audio.device)
            draws = draw_spec_augment(generator, audio.shape[0])
            audio = apply_spec_augment(audio, audio_len, draws)
        logits, logits_len = self(audio, audio_len, generator)
        log_probs = torch.log_softmax(logits, dim=-1)
        return ctc_loss_cuda(log_probs, text, logits_len, text_len, reduction="none").mean()

    def greedy_decode(self, audio: torch.Tensor,
                      audio_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frame-wise argmax ids (blank 0) and their lengths."""
        logits, logits_len = self(audio, audio_len)
        return logits.argmax(dim=-1), logits_len
