"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the port or JAX. The semantics follow the upstream
voice100 models as the repository documents them (``config/*.yaml``, the
JAX package's docstrings): a centred 512-point STFT log-mel front end;
conv blocks (Conv1d or ConvTranspose1d, channel LayerNorm eps 1e-5,
exact GELU); a bidirectional LSTM over padded rows with lengths, zero past
each length, the backward direction starting at each row's end; dropout
0.2 between LSTM layers in training; gradient clipping by global norm
(scale by max/norm once the norm reaches max); Adam (b1 0.9, b2 0.999,
eps 1e-8).

Random draws (augmentation, dropout) are made in the order and with the
calls of the trained model, from a generator seeded as the trainer's is,
so that the reference follows the same noise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LOG_OFFSET = 1e-6
BLANK_AUDIO = math.log(LOG_OFFSET)
TIME_BUCKET = 64
TEXT_BUCKET = 16


@contextlib.contextmanager
def precision(mode: str):
    """``"float32"`` (TF32 off) or ``"tf32"`` (TF32 on, the control) for
    every matmul, convolution and cuDNN RNN inside."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bucket(n: int, size: int) -> int:
    return max(size, -(-int(n) // size) * size)


def pad_rows(items: Sequence[np.ndarray], value, size: int, dtype=None):
    """Stack items padded with ``value`` to the bucketed longest length;
    returns ``(array, lengths)``."""
    lengths = np.asarray([len(x) for x in items], np.int64)
    first = np.asarray(items[0])
    out = np.full((len(items), bucket(lengths.max(), size)) + first.shape[1:], value,
                  dtype=dtype or first.dtype)
    for i, x in enumerate(items):
        out[i, :len(x)] = x
    return out, lengths


def sequence_mask(lengths: torch.Tensor, time: int) -> torch.Tensor:
    return torch.arange(time, device=lengths.device)[None, :] < lengths[:, None]


# -- front end ----------------------------------------------------------------

def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int = 257, n_mels: int = 64, sample_rate: int = 16000):
    """HTK-mel triangles without normalisation, ``[n_freqs, n_mels]``."""
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(wav: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` float32 at 16 kHz -> ``[B, N // 160 + 1, 64]``: a
    centred, reflect-padded STFT (n_fft 512, periodic Hann of 400 taps,
    hop 160), power, HTK mel, ``log(x + 1e-6)``."""
    window = torch.hann_window(400, periodic=True, dtype=torch.float32, device=wav.device)
    spec = torch.stft(wav, 512, 160, 400, window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                     # [B, 257, F]
    fb = torch.from_numpy(mel_filterbank()).to(wav.device)
    return torch.log(power.transpose(1, 2) @ fb + LOG_OFFSET)


# -- layers -------------------------------------------------------------------

def conv_block(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str, setting) -> torch.Tensor:
    """``[B, T, C]`` through one conv block of ``setting`` (out, transpose,
    kernel, stride, padding, bias)."""
    _, transpose, _, stride, padding, has_bias = setting
    bias = w[prefix + "conv.bias"] if has_bias else None
    conv = F.conv_transpose1d if transpose else F.conv1d
    y = conv(x.transpose(1, 2), w[prefix + "conv.weight"], bias, stride=stride,
             padding=padding).transpose(1, 2)
    y = F.layer_norm(y, (y.shape[-1],), w[prefix + "layer_norm.weight"],
                     w[prefix + "layer_norm.bias"], eps=1e-5)
    return F.gelu(y)


def conv_length(length, setting):
    _, transpose, kernel, stride, padding, _ = setting
    if transpose:
        return (length - 1) * stride - 2 * padding + kernel
    return (length + 2 * padding - kernel) // stride + 1


class BiLSTMStack(nn.Module):
    """One ``nn.LSTM`` (bidirectional, one layer) a layer, over packed
    rows; parameter names as the model's (``lstm.weight_ih_l0_reverse``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], prefix: str, layers: int) -> None:
        super().__init__()
        self.layers = nn.ModuleList()
        self.names: Dict[str, torch.Tensor] = {}
        for k in range(layers):
            w_ih = weights[f"{prefix}weight_ih_l{k}"]
            hidden = w_ih.shape[0] // 4
            lstm = nn.LSTM(w_ih.shape[1], hidden, batch_first=True, bidirectional=True,
                           device=w_ih.device)
            with torch.no_grad():
                for suffix in ("", "_reverse"):
                    for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                        param = getattr(lstm, f"{name}_l0{suffix}")
                        param.copy_(weights[f"{prefix}{name}_l{k}{suffix}"])
                        self.names[f"{prefix}{name}_l{k}{suffix}"] = param
            lstm.flatten_parameters()
            self.layers.append(lstm)

    def forward(self, x, lengths, dropout_p: float = 0.0, generator=None):
        time = x.shape[1]
        host_len = lengths.detach().cpu()
        for k, lstm in enumerate(self.layers):
            packed = nn.utils.rnn.pack_padded_sequence(x, host_len, batch_first=True,
                                                       enforce_sorted=False)
            out, _ = lstm(packed)
            x = nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=time)[0]
            if k < len(self.layers) - 1 and dropout_p > 0.0:
                x = dropout(x, dropout_p, generator)
        return x


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Zero each element with probability ``p``, scale the rest by 1/(1-p);
    one Bernoulli draw of the whole tensor."""
    keep = x.new_empty(x.shape).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), 0.0)


# -- optimisation ---------------------------------------------------------------

@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)


class Adam:
    """Adam with bias correction (b1 0.9, b2 0.999, eps 1e-8)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float) -> None:
        self.params, self.lr, self.t = params, lr, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, p in self.params.items():
            if p.grad is None:
                continue
            self.m[n].mul_(b1).add_(p.grad, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + eps))


def train_steps(params: Dict[str, torch.Tensor], loss_fn, batches, lr: float, clip: float):
    """Steps of ``loss_fn(batch)`` with the clip and Adam; returns the
    losses and the first step's clipped gradients by name."""
    opt = Adam(params, lr)
    losses, first = [], None
    for batch in batches:
        for p in params.values():
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        clip_by_global_norm([p.grad for p in params.values() if p.grad is not None], clip)
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in params.items()
                     if p.grad is not None}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, first
