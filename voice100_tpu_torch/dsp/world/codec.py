"""WORLD aperiodicity codec (coarse 3 kHz bands <-> full spectrum), numpy.

A copy of ``voice100_tpu/dsp/world/codec.py`` (pyworld's codec, as the
reference calls it at voice100/vocoder.py:73,100), host float64:
``code_aperiodicity`` samples the aperiodicity spectrum in dB at (b+1)*3
kHz; ``decode_aperiodicity`` rebuilds the full spectrum by linear dB
interpolation through anchors at 0 Hz (-60 dB), the coded bands and
Nyquist (~0 dB).
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_num_aperiodicities", "code_aperiodicity", "decode_aperiodicity"]

_FREQ_INTERVAL = 3000.0
_UPPER_LIMIT = 15000.0
_FLOOR_DB = -60.0
_SAFE_MIN = 1e-12


def get_num_aperiodicities(fs: int) -> int:
    """floor(min(15000, fs/2 - 3000) / 3000): 1 band at 16 kHz, 2 at
    22.05 kHz."""
    return int(min(_UPPER_LIMIT, fs / 2.0 - _FREQ_INTERVAL) // _FREQ_INTERVAL)


def code_aperiodicity(aperiodicity: np.ndarray, fs: int) -> np.ndarray:
    """``[T, fft//2+1]`` amplitude-ratio spectrum -> ``[T, bands]`` dB (float64)."""
    ap = np.asarray(aperiodicity, dtype=np.float64)
    t_frames, n_bins = ap.shape
    fft_size = (n_bins - 1) * 2
    n_bands = get_num_aperiodicities(fs)
    out = np.empty((t_frames, n_bands))
    for b in range(n_bands):
        pos = (b + 1) * _FREQ_INTERVAL * fft_size / fs
        lo = int(np.floor(pos))
        frac = pos - lo
        hi = min(lo + 1, n_bins - 1)
        val = ap[:, lo] * (1 - frac) + ap[:, hi] * frac
        out[:, b] = 20.0 * np.log10(np.maximum(val, _SAFE_MIN))
    return out


def decode_aperiodicity(coded: np.ndarray, fs: int, fft_size: int) -> np.ndarray:
    """``[T, bands]`` dB -> ``[T, fft_size//2+1]`` amplitude ratios (float64)."""
    coded = np.atleast_2d(np.asarray(coded, dtype=np.float64))
    n_bands = coded.shape[1]
    n_bins = fft_size // 2 + 1
    anchor_freqs = np.concatenate([[0.0], (np.arange(n_bands) + 1) * _FREQ_INTERVAL, [fs / 2.0]])
    anchor_vals = np.concatenate(
        [
            np.full((coded.shape[0], 1), _FLOOR_DB),
            coded,
            np.full((coded.shape[0], 1), 20.0 * np.log10(1.0 - _SAFE_MIN)),
        ],
        axis=1,
    )
    # shared anchors: interpolation is one matmul over all frames
    freqs = np.arange(n_bins) * fs / fft_size
    seg = np.clip(np.searchsorted(anchor_freqs, freqs, side="right") - 1,
                  0, len(anchor_freqs) - 2)
    span = anchor_freqs[seg + 1] - anchor_freqs[seg]
    w_hi = (freqs - anchor_freqs[seg]) / span
    weights = np.zeros((n_bins, len(anchor_freqs)))
    weights[np.arange(n_bins), seg] = 1.0 - w_hi
    weights[np.arange(n_bins), seg + 1] += w_hi
    out = anchor_vals @ weights.T
    return 10.0 ** (out / 20.0)
