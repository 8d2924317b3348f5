"""Fused log-mel front end: wrapper of the CUDA kernel ``csrc/melspec.cu``.

Replaces the TPU kernel ``voice100_tpu/ops/melspec_pallas.py::_kernel``
(``log_mel_spectrogram_pallas``). One launch takes the waveform itself:
each block stages a tile of frames' samples (reflect padding by index
arithmetic), windows them, runs a 512-point real FFT in shared memory
(a 256-point complex radix-4 FFT and a real split), and sums each mel
filter over its own bins, so neither the frames nor the ``[rows, 257]``
power spectrum reach device memory. The function is bound on the H100 by
its bytes (waveform in, features out); see the note at the top of the
CUDA source.

For a tensor on the CPU the wrapper runs the plain version,
:func:`voice100_tpu_torch.ops.melspec.log_mel_spectrogram` (dense DFT
products). For a CUDA tensor it launches the kernel or raises; it never
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels.build import check, load
from .melspec import LOG_OFFSET, MELSPEC_DIM, hann_window, log_mel_spectrogram, mel_filterbank

__all__ = ["log_mel_spectrogram_cuda", "kernel_constants"]

# the kernel's compile-time shape (csrc/melspec.cu)
_N_FFT = 512
_N_MELS = 64
_SMEM_LIMIT = 48 * 1024


def kernel_constants(n_fft: int, win_length: int, n_mels: int, sample_rate: int):
    """The kernel's host constants, numpy:

    * ``window [n_fft]`` float32, the plain version's Hann window;
    * ``twiddles [n_fft, 2]`` float32, ``exp(-2 pi i k / n_fft)`` for
      ``k < n_fft`` as (re, im), computed in float64 and rounded;
    * ``bands [3, n_mels]`` int32, each filter's first bin, bin count and
      offset into ``weights``;
    * ``weights`` float32, each filter's entries of
      ``mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)`` over its
      contiguous bin range, packed filter after filter.
    """
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)
    bands = np.zeros((3, n_mels), np.int32)
    weights = []
    for m in range(n_mels):
        nonzero = np.flatnonzero(fb[:, m])
        first = int(nonzero[0]) if nonzero.size else 0
        count = int(nonzero[-1]) - first + 1 if nonzero.size else 0
        bands[:, m] = first, count, sum(len(w) for w in weights)
        weights.append(fb[first:first + count, m])
    return (hann_window(win_length, n_fft).astype(np.float32), twiddles, bands,
            np.concatenate(weights).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _device_constants(win_length: int, sample_rate: int, device: torch.device):
    return tuple(
        torch.from_numpy(a).to(device)
        for a in kernel_constants(_N_FFT, win_length, _N_MELS, sample_rate)
    )


def _lib():
    lib = load("melspec")
    if lib.log_mel_f32.argtypes is None:
        lib.log_mel_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.log_mel_f32.restype = ctypes.c_int
        lib.log_mel_smem_bytes.argtypes = [ctypes.c_int]
        lib.log_mel_smem_bytes.restype = ctypes.c_int
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
    """``[..., T] -> [..., F, n_mels]`` float32 log-mel features,
    ``F = T // hop_length + 1``.

    On CUDA the kernel takes ``n_fft=512`` and ``n_mels=64`` only
    (``asr_en_base``'s front end) and ``T > n_fft // 2`` (reflect padding
    needs it); other values raise ``ValueError``.
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
    length = waveform.shape[-1]
    if length <= n_fft // 2:
        raise ValueError(f"log_mel_spectrogram_cuda: reflect padding needs more than "
                         f"{n_fft // 2} samples, got {length}")
    lib = _lib()
    if hop_length < 1 or lib.log_mel_smem_bytes(hop_length) > _SMEM_LIMIT:
        raise ValueError(f"log_mel_spectrogram_cuda: hop_length {hop_length} does not fit "
                         f"the kernel's shared memory")
    lead = waveform.shape[:-1]
    wav = waveform.to(torch.float32).reshape(-1, length).contiguous()
    n_frames = length // hop_length + 1
    window, twiddles, bands, weights = _device_constants(win_length, sample_rate,
                                                         waveform.device)
    out = torch.empty(wav.shape[0], n_frames, n_mels, dtype=torch.float32,
                      device=waveform.device)
    with torch.cuda.device(waveform.device):
        status = lib.log_mel_f32(
            wav.data_ptr(), window.data_ptr(), twiddles.data_ptr(), bands.data_ptr(),
            weights.data_ptr(), out.data_ptr(), wav.shape[0], length, n_frames, hop_length,
            log_offset, torch.cuda.current_stream().cuda_stream,
        )
    check(lib, status, "log_mel_f32")
    log_mel_spectrogram_cuda.launches += 1
    return out.reshape(*lead, n_frames, n_mels)


log_mel_spectrogram_cuda.launches = 0
