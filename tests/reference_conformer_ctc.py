"""Plain float32 reference of Conformer-CTC Large as NVIDIA NeMo trains it
(``examples/asr/conf/conformer/conformer_ctc_bpe.yaml``; Gulati et al.,
arXiv:2005.08100), for the port's tests.

Plain ``torch`` ops only: it imports neither JAX nor the port, and turns
TF32 off for matmuls and cuDNN. It follows NeMo's ``ConvSubsampling``
(``striding``), ``RelPositionalEncoding`` (x-scaling), ``ConformerLayer``,
``RelPositionMultiHeadAttention`` (scores materialised, the positional
term shifted by an explicit index ``T - 1 - i + j``), ``ConformerConvolution``
(BatchNorm over every frame, padded ones too), ``ConvASRDecoder``, the CTC
loss with ``mean_batch`` reduction (``F.ctc_loss``, reduction ``none``,
then the batch mean), ``SpecAugment``, ``adamw`` and ``NoamAnnealing``.

Departures from NeMo:

* the blank is id 0 (NeMo's is the last id): the decoder's rows permuted;
* ``pos_bias_u``/``pos_bias_v`` are whatever the weights hold (the tests
  and the benchmark seed them; NeMo starts them at 0);
* the pointwise convolutions and the decoder take ``[out, in]`` weights (a
  kernel-1 ``Conv1d``'s weight without its last axis);
* randomness is replayed, not NeMo's: SpecAugment's uniforms
  (``[B, 24]``, one ``torch.rand``: 2 frequency starts, 2 frequency
  widths, 10 time starts, 10 time widths, mapped onto NeMo's inclusive
  integer ranges) and every dropout mask (one uint8 ``bernoulli_`` a
  tensor) are drawn from the step's generator before the forward, in the
  port's documented order (:func:`draw_masks`);
* padded feature frames hold the collate's padding value (NeMo pads its
  normalised features with 0);
* the AdamW moments start at zero at the configured ``start_step``, as a
  run resumed from weights alone would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FREQ_MASKS, FREQ_WIDTH, TIME_MASKS, TIME_WIDTH = 2, 27, 10, 0.05
MASKED = -10000.0

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def calc_length(lengths, n_convs: int = 2):
    """NeMo's ``calc_length``: floor((L + 2 - 3) / 2) + 1 a conv."""
    for _ in range(n_convs):
        lengths = torch.floor((lengths.to(torch.float64) + 2 - 3) / 2 + 1).to(torch.int64)
    return lengths


def noam(step: int, d_model: int, peak: float, warmup: int, min_lr: float) -> float:
    step = max(1, step)
    lr = peak * d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)
    return max(lr, min_lr) if step > warmup else lr


def positions(time: int, d_model: int, device) -> torch.Tensor:
    pos = torch.arange(time - 1, -time, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(2 * time - 1, d_model, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def bernoulli_keep(shape, p, generator, device):
    return torch.empty(shape, dtype=torch.uint8, device=device).bernoulli_(1 - p,
                                                                           generator=generator)


def draw_masks(generator, batch: int, time_sub: int, cfg: dict) -> Dict[str, object]:
    """Every draw of one training step after SpecAugment's, in order: the
    pre-encoder mask, then each block's seven (ffn1 inner, ffn1 out,
    attention probabilities, attention out, conv out, ffn2 inner, ffn2
    out). A rate of 0 draws nothing (None)."""
    d, h = cfg["d_model"], cfg["n_heads"]
    e = cfg["ff_expansion_factor"]
    dev = generator.device

    def draw(shape, p):
        return bernoulli_keep(shape, p, generator, dev) if p > 0 else None

    p, pa = cfg["dropout"], cfg["dropout_att"]
    out = {"pre": draw((batch, time_sub, d), cfg["dropout_pre_encoder"]), "layers": []}
    for _ in range(cfg["n_layers"]):
        out["layers"].append([draw((batch, time_sub, e * d), p), draw((batch, time_sub, d), p),
                              draw((batch, h, time_sub, time_sub), pa),
                              draw((batch, time_sub, d), p), draw((batch, time_sub, d), p),
                              draw((batch, time_sub, e * d), p), draw((batch, time_sub, d), p)])
    return out


def spec_augment(audio, audio_len, u):
    """NeMo's SpecAugment masks, set to 0, from uniforms ``u [B, 24]``."""
    b, time, dim = audio.shape
    width = min(FREQ_WIDTH, dim)
    out = audio.clone()
    for r in range(b):
        row = u[r].double().tolist()
        length = int(audio_len[r])
        t_max = max(1, int(math.floor(length * TIME_WIDTH)))
        for m in range(FREQ_MASKS):
            start = min(int(math.floor(row[m] * (dim - width + 1))), dim - width)
            w = min(int(math.floor(row[FREQ_MASKS + m] * (width + 1))), width)
            out[r, :, start:start + w] = 0.0
        for m in range(TIME_MASKS):
            hi = max(1, length - t_max)
            start = min(int(math.floor(row[2 * FREQ_MASKS + m] * (hi + 1))), hi)
            w = min(int(math.floor(row[2 * FREQ_MASKS + TIME_MASKS + m] * (t_max + 1))), t_max)
            out[r, start:start + w, :] = 0.0
    return out


def _drop(x, keep, p):
    return x if keep is None else x * keep.to(x.dtype) / (1 - p)


class ConformerReference:
    """Conformer-CTC over a dict of weights named as the port's
    ``state_dict`` (BatchNorm running averages kept here as buffers)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 buffers: Optional[Dict[str, torch.Tensor]] = None) -> None:
        self.cfg = {"d_model": 512, "n_heads": 8, "n_layers": 18, "ff_expansion_factor": 4,
                    "conv_kernel_size": 31, "dropout": 0.1, "dropout_att": 0.1,
                    "dropout_pre_encoder": 0.1, "weight_decay": 1e-3, "warmup_steps": 10000,
                    "peak_lr": 2.0, "min_lr": 1e-6, **cfg}
        self.params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
        device = next(iter(weights.values())).device
        d = self.cfg["d_model"]
        self.buffers = {}
        for i in range(self.cfg["n_layers"]):
            pre = f"layers.{i}.conv.batch_norm."
            self.buffers[pre + "running_mean"] = torch.zeros(d, device=device)
            self.buffers[pre + "running_var"] = torch.ones(d, device=device)
        if buffers:
            self.buffers.update({n: b.detach().clone() for n, b in buffers.items()
                                 if n in self.buffers})

    # -- forward ------------------------------------------------------------------------
    def _linear(self, x, name, bias=True):
        w = self.params
        return F.linear(x, w[name + ".weight"], w[name + ".bias"] if bias else None)

    def _ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.params[name + ".weight"],
                            self.params[name + ".bias"], eps=1e-5)

    def subsample(self, audio, audio_len):
        x = audio[:, None]
        for k in range(2):
            x = torch.relu(F.conv2d(x, self.params[f"pre_encode.conv.{k}.weight"],
                                    self.params[f"pre_encode.conv.{k}.bias"], stride=2,
                                    padding=1))
        b, c, t, f = x.shape
        x = self._linear(x.transpose(1, 2).reshape(b, t, c * f), "pre_encode.out")
        return x, calc_length(audio_len)

    def attention(self, x, lengths, pos, prefix, keep, train):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg["n_heads"]
        dk = d // h
        q = self._linear(x, prefix + "linear_q").view(b, t, h, dk).transpose(1, 2)
        k = self._linear(x, prefix + "linear_k").view(b, t, h, dk).transpose(1, 2)
        v = self._linear(x, prefix + "linear_v").view(b, t, h, dk).transpose(1, 2)
        p = self._linear(pos, prefix + "linear_pos", bias=False).view(2 * t - 1, h, dk)
        u = self.params[prefix + "pos_bias_u"][None, :, None, :]
        vb = self.params[prefix + "pos_bias_v"][None, :, None, :]
        ac = (q + u) @ k.transpose(-1, -2)
        full = (q + vb) @ p.permute(1, 2, 0)                          # [B, H, T, 2T - 1]
        i = torch.arange(t, device=x.device)
        index = (t - 1 - i[:, None] + i[None, :]).expand(b, h, t, t)  # row T - 1 - i + j
        bd = torch.gather(full, 3, index)
        scores = (ac + bd) / math.sqrt(dk)
        valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        masked = ~(valid[:, None, :, None] & valid[:, None, None, :])
        scores = scores.masked_fill(masked, MASKED)
        attn = torch.softmax(scores, dim=-1).masked_fill(masked, 0.0)
        attn = _drop(attn, keep, cfg["dropout_att"]) if train else attn
        o = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return self._linear(o, prefix + "linear_out")

    def conv_module(self, x, valid, prefix, train):
        w = self.params
        d = x.shape[-1]
        y = F.glu(self._linear(x, prefix + "pointwise_conv1").transpose(1, 2), dim=1)
        y = y.masked_fill(~valid[:, None, :], 0.0)
        y = F.conv1d(y, w[prefix + "depthwise_conv.weight"], w[prefix + "depthwise_conv.bias"],
                     padding=(self.cfg["conv_kernel_size"] - 1) // 2, groups=d)
        y = F.batch_norm(y, self.buffers[prefix + "batch_norm.running_mean"],
                         self.buffers[prefix + "batch_norm.running_var"],
                         w[prefix + "batch_norm.weight"], w[prefix + "batch_norm.bias"],
                         training=train, momentum=0.1, eps=1e-5)
        y = y * torch.sigmoid(y)
        return self._linear(y.transpose(1, 2), prefix + "pointwise_conv2")

    def ffn(self, x, prefix, keep, train):
        y = self._linear(x, prefix + "linear1")
        y = y * torch.sigmoid(y)
        y = _drop(y, keep, self.cfg["dropout"]) if train else y
        return self._linear(y, prefix + "linear2")

    def block(self, x, lengths, valid, pos, i, keeps, train):
        pre = f"layers.{i}."
        p = self.cfg["dropout"]
        keeps = keeps if train else [None] * 7

        def drop(y, keep):
            return _drop(y, keep, p) if train else y

        x = x + 0.5 * drop(self.ffn(self._ln(x, pre + "norm_feed_forward1"),
                                    pre + "feed_forward1.", keeps[0], train), keeps[1])
        x = x + drop(self.attention(self._ln(x, pre + "norm_self_att"), lengths, pos,
                                    pre + "self_attn.", keeps[2], train), keeps[3])
        x = x + drop(self.conv_module(self._ln(x, pre + "norm_conv"), valid, pre + "conv.",
                                      train), keeps[4])
        x = x + 0.5 * drop(self.ffn(self._ln(x, pre + "norm_feed_forward2"),
                                    pre + "feed_forward2.", keeps[5], train), keeps[6])
        return self._ln(x, pre + "norm_out")

    def forward(self, audio, audio_len, masks=None, train=False):
        """Logits ``[B, T', V]`` and lengths; ``masks`` from
        :func:`draw_masks` in training."""
        x, lengths = self.subsample(audio, audio_len)
        t = x.shape[1]
        pos = positions(t, self.cfg["d_model"], x.device)
        x = x * math.sqrt(self.cfg["d_model"])
        if train:
            x = _drop(x, masks["pre"], self.cfg["dropout_pre_encoder"])
        valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        for i in range(self.cfg["n_layers"]):
            x = self.block(x, lengths, valid, pos, i, masks["layers"][i] if train else None,
                           train)
        return self._linear(x, "decoder"), lengths

    # -- training -----------------------------------------------------------------------
    def loss(self, audio, audio_len, text, text_len, generator=None, train=True):
        """The ``mean_batch`` CTC loss; in training SpecAugment's draws and
        every mask come from ``generator``, in the port's order."""
        masks = None
        if train:
            u = torch.rand(audio.shape[0], 2 * (FREQ_MASKS + TIME_MASKS), generator=generator,
                           device=generator.device)
            audio = spec_augment(audio, audio_len, u)
            t_sub = int(calc_length(torch.tensor(audio.shape[1])))
            masks = draw_masks(generator, audio.shape[0], t_sub, self.cfg)
        logits, lengths = self.forward(audio, audio_len, masks, train)
        log_probs = torch.log_softmax(logits, dim=-1)
        per_row = F.ctc_loss(log_probs.transpose(0, 1), text, lengths, text_len, blank=0,
                             reduction="none", zero_infinity=True)
        return per_row.mean()

    def train(self, batches: Sequence, generator, start_step: int = 0):
        """AdamW (betas 0.9, 0.98, eps 1e-8, the configured weight decay)
        under Noam from ``start_step``, no clipping, one step a batch
        ``(audio, audio_len, text, text_len)``; returns the losses and the
        first step's gradients."""
        cfg = self.cfg
        m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        losses: List[float] = []
        first = None
        for t, batch in enumerate(batches, 1):
            for p in self.params.values():
                p.grad = None
            loss = self.loss(*batch, generator=generator)
            loss.backward()
            if first is None:
                first = {n: p.grad.detach().clone() for n, p in self.params.items()}
            lr = noam(start_step + t - 1, cfg["d_model"], cfg["peak_lr"], cfg["warmup_steps"],
                      cfg["min_lr"])
            with torch.no_grad():
                for n, p in self.params.items():
                    g = p.grad
                    p.mul_(1 - lr * cfg["weight_decay"])
                    m[n].mul_(0.9).add_(g, alpha=0.1)
                    v[n].mul_(0.98).addcmul_(g, g, value=0.02)
                    denom = (v[n] / (1 - 0.98 ** t)).sqrt() + 1e-8
                    p.sub_(lr * (m[n] / (1 - 0.9 ** t)) / denom)
            losses.append(float(loss.detach()))
        return losses, first
