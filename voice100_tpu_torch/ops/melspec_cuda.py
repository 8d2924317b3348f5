"""Fused log-mel front end: wrapper of the CUDA kernel ``csrc/melspec.cu``.

Replaces the TPU kernel ``voice100_tpu/ops/melspec_pallas.py::_kernel``
(``log_mel_spectrogram_pallas``). The kernel keeps a tile of frames in
shared memory through DFT -> power -> mel -> log, so the ``[rows, 257]``
power spectrum never reaches device memory. The function is bound on
the H100 by its bytes (waveform in, features out); this design, which
does the DFT as dense products, by its float32 operations (about
``2 * rows * 512 * 257 * 2``). See the note at the top of the CUDA
source for what the design does about that.

For a tensor on the CPU the wrapper runs the plain version,
:func:`voice100_tpu_torch.ops.melspec.log_mel_spectrogram`. For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels.build import check, load
from .melspec import (
    LOG_OFFSET, MELSPEC_DIM, frame_signal, hann_window, log_mel_spectrogram,
    mel_filterbank,
)

__all__ = ["log_mel_spectrogram_cuda", "folded_constants"]

# the kernel's compile-time shape (csrc/melspec.cu)
_N_FFT = 512
_N_MELS = 64


def folded_constants(n_fft: int, win_length: int, n_mels: int, sample_rate: int):
    """``cos_w, sin_w [n_fft, n_fft//2+1]`` with the Hann window folded in
    (as ``melspec_pallas.py:48-61`` folds it, without the lane padding)
    and the filterbank ``[n_fft//2+1, n_mels]``, float32 numpy."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None] * np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    window = hann_window(win_length, n_fft)[:, None]
    return (
        (np.cos(ang) * window).astype(np.float32),
        (-np.sin(ang) * window).astype(np.float32),
        mel_filterbank(n_freq, n_mels, sample_rate),
    )


@functools.lru_cache(maxsize=8)
def _device_constants(win_length: int, sample_rate: int, device: torch.device):
    return tuple(
        torch.from_numpy(a).to(device)
        for a in folded_constants(_N_FFT, win_length, _N_MELS, sample_rate)
    )


def _lib():
    lib = load("melspec")
    if lib.log_mel_f32.argtypes is None:
        lib.log_mel_f32.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.log_mel_f32.restype = ctypes.c_int
    return lib


def log_mel_spectrogram_cuda(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = MELSPEC_DIM,
    log_offset: float = LOG_OFFSET,
) -> torch.Tensor:
    """``[..., T] -> [..., F, n_mels]`` float32 log-mel features.

    On CUDA the kernel takes ``n_fft=512`` and ``n_mels=64`` only
    (``asr_en_base``'s front end); other values raise ``ValueError``.
    """
    if waveform.device.type == "cpu":
        return log_mel_spectrogram(
            waveform, sample_rate, n_fft, win_length, hop_length, n_mels, log_offset
        )
    if waveform.device.type != "cuda":
        raise ValueError(f"log_mel_spectrogram_cuda: unsupported device {waveform.device}")
    if n_fft != _N_FFT or n_mels != _N_MELS:
        raise ValueError(
            f"the log-mel kernel is built for n_fft={_N_FFT}, n_mels={_N_MELS}; "
            f"got n_fft={n_fft}, n_mels={n_mels}"
        )
    frames = frame_signal(waveform.to(torch.float32), n_fft, hop_length)
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    flat = frames.reshape(-1, n_fft).contiguous()
    if flat.data_ptr() % 16:
        raise ValueError("log_mel_spectrogram_cuda: frames must be 16-byte aligned")
    cos_w, sin_w, fb = _device_constants(win_length, sample_rate, waveform.device)
    rows = flat.shape[0]
    out = torch.empty(rows, n_mels, dtype=torch.float32, device=waveform.device)
    lib = _lib()
    with torch.cuda.device(waveform.device):
        status = lib.log_mel_f32(
            flat.data_ptr(), cos_w.data_ptr(), sin_w.data_ptr(), fb.data_ptr(),
            out.data_ptr(), rows, log_offset,
            torch.cuda.current_stream().cuda_stream,
        )
    check(lib, status, "log_mel_f32")
    log_mel_spectrogram_cuda.launches += 1
    return out.reshape(*lead, n_frames, n_mels)


log_mel_spectrogram_cuda.launches = 0
