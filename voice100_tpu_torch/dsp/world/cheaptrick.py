"""CheapTrick spectral-envelope estimation (vectorized host NumPy, float64).

A copy of the NumPy path of ``voice100_tpu/dsp/world/cheaptrick.py:26-170``
(``backend="numpy"``, ``xp=np``), the published CheapTrick algorithm
(Morise 2015) the reference uses through pyworld (voice100/vocoder.py:70):
pitch-synchronous Hanning windowing (3 periods), DC correction below F0,
rectangular spectral smoothing of width 2 F0 / 3, and cepstral liftering
with the q1 = -0.15 compensation lifter, all frames as one batched FFT
workload. The same code on the same float64 input gives the JAX
package's envelope bit for bit. The device backend is not ported
(:mod:`.backend`).
"""

from __future__ import annotations

import numpy as np

from .backend import require_host_backend

__all__ = ["cheaptrick", "DEFAULT_F0", "f0_floor_for_fft_size"]

DEFAULT_F0 = 500.0
_Q1 = -0.15
_EPS = 1e-9


def f0_floor_for_fft_size(fs: int, fft_size: int) -> float:
    """Lowest F0 whose 3-period window fits the FFT."""
    return 3.0 * fs / (fft_size - 3.0)


def _windowed_frames(x, fs, f0, positions, fft_size):
    """Extract 3-period Hanning-windowed, bias-removed frames
    ``[T, fft_size]``."""
    half_max = fft_size // 2 - 1
    offsets = np.arange(-half_max, half_max + 1)  # [W]
    half_len = np.round(1.5 * fs / f0).astype(np.int32)  # [T]
    centers = np.round(positions * fs).astype(np.int32)  # [T]
    idx = centers[:, None] + offsets[None, :]
    idx = np.clip(idx, 0, x.shape[0] - 1)
    seg = x[idx]  # [T, W]
    in_window = np.abs(offsets[None, :]) <= half_len[:, None]
    phase = offsets[None, :] / (1.5 * fs / f0[:, None])
    window = (0.5 + 0.5 * np.cos(np.pi * phase)) * in_window
    wave = seg * window
    # remove window-weighted mean so the DC bin carries no bias
    coeff = wave.sum(axis=1, keepdims=True) / np.maximum(
        window.sum(axis=1, keepdims=True), 1e-12
    )
    wave = wave - window * coeff
    # normalize window energy: the power spectrum then estimates the
    # per-sample PSD, making analysis->synthesis energy-consistent
    wave = wave / np.sqrt(
        np.maximum((window**2).sum(axis=1, keepdims=True), 1e-12)
    )
    return np.pad(wave, ((0, 0), (0, fft_size - wave.shape[1])))


def _dc_correction(power, fs, fft_size, f0):
    """Mirror spectral content around F0 into the bins below F0."""
    n_bins = fft_size // 2 + 1
    freqs = np.arange(n_bins) * fs / fft_size  # [F]
    mirror_freq = 2.0 * f0[:, None] - freqs[None, :]  # [T, F]
    pos = mirror_freq * fft_size / fs
    pos = np.clip(pos, 0, n_bins - 1)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, n_bins - 1)
    frac = pos - lo
    rows = np.arange(power.shape[0])[:, None]
    replica = power[rows, lo] * (1 - frac) + power[rows, hi] * frac
    below = freqs[None, :] < f0[:, None]
    return power + np.where(below, replica, 0.0)


def _linear_smoothing(power, fs, fft_size, width, max_width):
    """Rectangular smoothing of width ``width`` Hz, with the spectrum
    mirrored at DC and Nyquist so edge windows integrate real energy
    (WORLD's mirroring trick). ``max_width`` must be a python float
    upper bound on width (the number of shifted bins summed).

    Computed as a direct overlap-weighted sum over neighboring bins
    (piecewise-constant density), NOT as a difference of integrated
    spectra: power spans many orders of magnitude across frequency, and
    the cumsum formulation catastrophically cancels in float32 (the
    quiet valleys between formants would carry ~20 dB of error).
    """
    n_bins = fft_size // 2 + 1
    bin_hz = fs / fft_size
    margin = int(np.ceil(max_width / 2.0 / bin_hz)) + 2
    margin = min(margin, n_bins - 1)
    ext = np.concatenate(
        [power[:, margin:0:-1], power, power[:, -2:-2 - margin:-1]], axis=1
    )  # [T, F + 2*margin], sample m at freq (m - margin) * bin_hz
    half = width[:, None] / 2.0  # [T, 1]
    out = np.zeros_like(power)
    for k in range(-margin, margin + 1):
        # overlap of bin at offset k (segment k*bin +- bin/2) with the
        # rect window [-w/2, w/2], in Hz
        seg_lo = (k - 0.5) * bin_hz
        seg_hi = (k + 0.5) * bin_hz
        overlap = np.clip(
            np.minimum(half, seg_hi) - np.maximum(-half, seg_lo),
            0.0, bin_hz,
        )  # [T, 1]
        out = out + ext[:, margin + k: margin + k + n_bins] * overlap
    return out / width[:, None]


def _lifter(log_power, fs, fft_size, f0):
    """Cepstral smoothing + q1 compensation liftering."""
    cep = np.fft.irfft(log_power, n=fft_size, axis=1)  # even symmetric
    q = np.arange(fft_size // 2 + 1) / fs  # quefrency of bins 0..N/2
    arg = np.pi * f0[:, None] * q[None, :]
    smoothing = np.where(
        arg == 0, 1.0,
        np.sin(np.maximum(arg, 1e-12)) / np.maximum(arg, 1e-12),
    )
    compensation = (1.0 - 2.0 * _Q1) + 2.0 * _Q1 * np.cos(2.0 * arg)
    lifter_half = smoothing * compensation
    # apply symmetrically to the full cepstrum
    full = np.concatenate(
        [lifter_half, lifter_half[:, -2:0:-1]], axis=1
    )
    cep = cep * full
    return np.exp(np.fft.rfft(cep, n=fft_size, axis=1).real)


def _cheaptrick_impl(x, f0, positions, fs, fft_size):
    floor = f0_floor_for_fft_size(fs, fft_size)
    eff_f0 = np.where(f0 <= floor, DEFAULT_F0, f0)
    frames = _windowed_frames(x, fs, eff_f0, positions, fft_size)
    spec = np.fft.rfft(frames, n=fft_size, axis=1)
    power = spec.real**2 + spec.imag**2
    power = _dc_correction(power, fs, fft_size, eff_f0)
    power = _linear_smoothing(
        power, fs, fft_size, eff_f0 * 2.0 / 3.0,
        max_width=DEFAULT_F0 * 2.0 / 3.0,
    )
    tiny = np.finfo(power.dtype).tiny
    power = np.maximum(
        power, _EPS * power.max(axis=1, keepdims=True) + tiny
    )
    return _lifter(np.log(power), fs, fft_size, eff_f0)


def cheaptrick(
    x: np.ndarray,
    f0: np.ndarray,
    positions: np.ndarray,
    fs: int,
    fft_size: int = 512,
    backend: str = "numpy",
) -> np.ndarray:
    """Estimate the power spectral envelope ``[T, fft_size//2+1]``.

    Unvoiced frames (f0 at/below the window floor) use the 500 Hz
    default window, as WORLD does. ``backend`` must be ``"numpy"``.
    """
    require_host_backend(backend)
    x = np.asarray(x, dtype=np.float64)
    f0 = np.asarray(f0, dtype=np.float64)
    return _cheaptrick_impl(x, f0, positions, fs, fft_size)
