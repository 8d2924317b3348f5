"""Log-mel spectrogram front end, plain PyTorch.

Port of ``voice100_tpu/ops/melspec.py`` (torch.stft semantics: 16 kHz,
n_fft=512, win=400, hop=160, centred reflect padding, periodic Hann
window zero-padded to n_fft, power-2 spectrum, HTK mel scale without
normalisation, ``log(x + 1e-6)``). The DFT runs as two matmuls and the
mel projection as a third, in float32, as the JAX reference runs them at
``Precision.HIGHEST``.

This is the plain version of the fused CUDA kernel in
``ops/melspec_cuda.py``; that wrapper runs it for tensors on the CPU.
The numpy constants are rebuilt here because the JAX module imports jax.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "hann_window",
    "mel_filterbank",
    "frame_signal",
    "log_mel_spectrogram",
    "num_frames",
    "LOG_OFFSET",
    "MELSPEC_DIM",
]

LOG_OFFSET = 1e-6
MELSPEC_DIM = 64


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, zero-padded (centred) to
    ``n_fft`` (the torch.stft convention), float64."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    pad_left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[pad_left:pad_left + win_length] = w
    return out


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """Triangular HTK-mel filterbank ``[n_freqs, n_mels]`` (norm=None),
    float32, as torchaudio.functional.melscale_fbanks builds it."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(mel_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                      # [n_mels+1]
    slopes = f_pts[None, :] - all_freqs[:, None]         # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def num_frames(n_samples, hop_length: int):
    """Frame count for a centred STFT (ints, arrays or tensors)."""
    return n_samples // hop_length + 1


def frame_signal(waveform: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """``[..., T] -> [..., F, n_fft]`` with centred reflect padding,
    ``F = T // hop_length + 1``. Reflect padding needs ``T > n_fft // 2``."""
    lead = waveform.shape[:-1]
    pad = n_fft // 2
    x = F.pad(waveform.reshape(-1, 1, waveform.shape[-1]), (pad, pad), mode="reflect")
    frames = x[:, 0].unfold(-1, n_fft, hop_length)       # [N, F, n_fft]
    return frames.reshape(*lead, frames.shape[-2], n_fft)


@functools.lru_cache(maxsize=8)
def _constants(n_fft: int, win_length: int, n_mels: int, sample_rate: int):
    """Host constants: window ``[n_fft]``, real-DFT cos / -sin
    ``[n_fft, n_fft//2+1]`` and the filterbank ``[n_fft//2+1, n_mels]``."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None] * np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    return (
        hann_window(win_length, n_fft).astype(np.float32),
        np.cos(ang).astype(np.float32),
        (-np.sin(ang)).astype(np.float32),
        mel_filterbank(n_freq, n_mels, sample_rate),
    )


def log_mel_spectrogram(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = MELSPEC_DIM,
    log_offset: float = LOG_OFFSET,
) -> torch.Tensor:
    """``[..., T] -> [..., F, n_mels]`` float32 log-mel features."""
    window, cos_m, sin_m, fb = (
        torch.from_numpy(a).to(waveform.device)
        for a in _constants(n_fft, win_length, n_mels, sample_rate)
    )
    frames = frame_signal(waveform.to(torch.float32), n_fft, hop_length) * window
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    mel = torch.matmul(re * re + im * im, fb)
    return torch.log(mel + log_offset)
