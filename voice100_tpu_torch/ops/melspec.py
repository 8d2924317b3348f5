"""Log-mel spectrogram front end, plain PyTorch.

Port of ``voice100_tpu/ops/melspec.py`` (torch.stft semantics: 16 kHz,
n_fft=512, win=400, hop=160, centred reflect padding, periodic Hann
window zero-padded to n_fft, power-2 spectrum, HTK mel scale without
normalisation, ``log(x + 1e-6)``). The DFT runs as two matmuls and the
mel projection as a third, in float32, as the JAX reference runs them at
``Precision.HIGHEST``.

This is the plain version of the fused CUDA kernel in
``ops/melspec_cuda.py``; that wrapper runs it for tensors on the CPU.
:func:`power_spectrum` is the power STFT alone (the DFT products).
The numpy constants are rebuilt here because the JAX module imports jax.
:func:`log_mel_spectrogram_np` is a copy of the JAX package's host NumPy
twin (``voice100_tpu/ops/melspec.py:165``), which ONNX serving runs.
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
    "power_spectrum",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
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
def _window(win_length: int, n_fft: int) -> np.ndarray:
    """The float32 Hann window ``[n_fft]``, a host constant."""
    return hann_window(win_length, n_fft).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int):
    """Real-DFT cos / -sin ``[n_fft, n_fft//2+1]``, float32 host constants."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None] * np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _filterbank(n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """The filterbank ``[n_fft//2+1, n_mels]``, a host constant."""
    return mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)


def power_spectrum(waveform: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int) -> torch.Tensor:
    """``[..., T] -> [..., F, n_fft//2+1]`` power-2 STFT magnitude in the
    waveform's dtype, through the real-DFT cos and -sin products."""
    window, cos_m, sin_m = (torch.from_numpy(a).to(waveform.device, waveform.dtype)
                            for a in (_window(win_length, n_fft), *_dft_matrices(n_fft)))
    frames = frame_signal(waveform, n_fft, hop_length) * window
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    return re * re + im * im


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
    fb = torch.from_numpy(_filterbank(n_fft, n_mels, sample_rate)).to(waveform.device)
    mel = torch.matmul(power_spectrum(waveform.to(torch.float32), n_fft, hop_length, win_length),
                       fb)
    return torch.log(mel + log_offset)


def log_mel_spectrogram_np(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = MELSPEC_DIM,
    log_offset: float = LOG_OFFSET,
) -> np.ndarray:
    """Host NumPy twin of :func:`log_mel_spectrogram` (the same torch.stft
    semantics through ``np.fft.rfft``), for serving paths without torch
    (:mod:`voice100_tpu_torch.onnx.serve`)."""
    window, fb = _window(win_length, n_fft), _filterbank(n_fft, n_mels, sample_rate)
    x = np.asarray(waveform, np.float32)
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    frames = x.shape[-1] // hop_length + 1
    idx = np.arange(frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(xp[idx] * window, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    return np.log(power @ fb + log_offset)
