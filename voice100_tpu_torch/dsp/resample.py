"""Sample-rate conversion (windowed-sinc polyphase, NumPy host-side).

A copy of ``voice100_tpu/dsp/resample.py``: the port imports nothing of
the JAX package. Replaces torchaudio.functional.resample / sox ``rate``
as used by the reference data pipeline (voice100/data_modules.py:289,303-314). Same
family of algorithm as torchaudio's sinc_interp_hann: zero-stuffed
windowed-sinc lowpass at the target Nyquist with rolloff 0.99 and
filter width 6 zero crossings.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["resample"]


@lru_cache(maxsize=32)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float):
    """Polyphase kernels ``[new_freq, width]`` (after gcd reduction)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernels.astype(np.float32), width


def resample(
    waveform: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Resample ``[..., T]`` float waveform between integer rates."""
    if orig_freq == new_freq:
        return np.asarray(waveform, dtype=np.float32)
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernels, width = _kernel(orig, new, lowpass_filter_width, rolloff)

    x = np.asarray(waveform, dtype=np.float32)
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    n = shape[-1]
    target_len = int(math.ceil(n * new / orig))
    padded = np.pad(x, [(0, 0), (width, width + orig)])
    # frames of stride `orig`, one output sample per (phase, frame)
    num_frames = (padded.shape[1] - kernels.shape[1]) // orig + 1
    out = np.zeros((x.shape[0], num_frames * new), dtype=np.float32)
    k_len = kernels.shape[1]
    strided = np.lib.stride_tricks.as_strided(
        padded,
        shape=(x.shape[0], num_frames, k_len),
        strides=(
            padded.strides[0],
            padded.strides[1] * orig,
            padded.strides[1],
        ),
    )
    # [B, F, K] x [P, K] -> [B, F, P] -> interleave phases
    mixed = np.einsum("bfk,pk->bfp", strided, kernels)
    out = mixed.reshape(x.shape[0], -1)[:, :target_len]
    return out.reshape(shape[:-1] + (target_len,))
