"""WORLD synthesis on host NumPy (framework-free serving fallback).

A copy of ``voice100_tpu/dsp/world/synthesis_np.py``. The same algorithm as the JAX package's jitted synthesizer: pulse
positions from wrapped cumulative phase, per-pulse minimum-phase
impulse responses for the periodic and aperiodic parts, overlap-add.
Used by the ONNX serving classes so exported artifacts can be served
without torch on the host, and is the reference of the native C++
synthesis (:mod:`voice100_tpu_torch.native.world`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthesize_np"]

_DEFAULT_F0 = 200.0


def _min_phase_ir_np(log_power_half: np.ndarray, fft_size: int,
                     out_fft: int) -> np.ndarray:
    cep = np.fft.irfft(0.5 * log_power_half, n=fft_size, axis=-1)
    n = fft_size
    lifter = np.concatenate([
        np.ones(1), 2.0 * np.ones(n // 2 - 1), np.ones(1),
        np.zeros(n // 2 - 1),
    ])
    min_phase_spec = np.exp(np.fft.rfft(cep * lifter[None, :], axis=-1))
    ir = np.fft.irfft(min_phase_spec, n=fft_size, axis=-1)
    return np.fft.rfft(ir, n=out_fft, axis=-1)


def synthesize_np(
    f0: np.ndarray,
    spectrogram: np.ndarray,
    aperiodicity: np.ndarray,
    fs: int = 16000,
    frame_period: float = 10.0,
    fft_size: int = None,
    seed: int = 0,
) -> np.ndarray:
    """(f0 [T], power envelope [T, F], aperiodicity ratio [T, F]) ->
    waveform; mirrors synthesis.synthesize's math on host."""
    f0 = np.asarray(f0, np.float64)
    spectrogram = np.asarray(spectrogram, np.float64)
    aperiodicity = np.asarray(aperiodicity, np.float64)
    n_frames = f0.shape[0]
    if fft_size is None:
        fft_size = 2 * (spectrogram.shape[1] - 1)
    hop = fs * frame_period / 1000.0
    out_len = int(round((n_frames - 1) * hop)) + 1

    # per-sample F0 (linear interpolation; default rate when unvoiced)
    sample_pos = np.arange(out_len) / hop
    fr0 = np.clip(np.floor(sample_pos).astype(np.int64), 0, n_frames - 1)
    fr1 = np.minimum(fr0 + 1, n_frames - 1)
    w = sample_pos - fr0
    f0_a, f0_b = f0[fr0], f0[fr1]
    voiced_a, voiced_b = f0_a > 0, f0_b > 0
    f0_interp = np.where(
        voiced_a & voiced_b,
        f0_a * (1 - w) + f0_b * w,
        np.where(voiced_a, f0_a, np.where(voiced_b, f0_b, 0.0)),
    )
    rate = np.where(f0_interp > 0, f0_interp, _DEFAULT_F0)
    rate = np.clip(rate, 40.0, 420.0)

    # pulse positions from wrapped cumulative phase
    phase = np.cumsum(rate / fs)
    wraps = np.floor(phase)
    is_pulse = np.concatenate([[True], (wraps[1:] - wraps[:-1]) >= 1.0])
    pulse_pos = np.nonzero(is_pulse)[0]

    # per-pulse envelopes
    p_frame = pulse_pos / hop
    pf0 = np.clip(np.floor(p_frame).astype(np.int64), 0, n_frames - 1)
    pf1 = np.minimum(pf0 + 1, n_frames - 1)
    pw = (p_frame - pf0)[:, None]
    sp = spectrogram[pf0] * (1 - pw) + spectrogram[pf1] * pw
    ap = aperiodicity[pf0] * (1 - pw) + aperiodicity[pf1] * pw
    pulse_voiced = f0_interp[pulse_pos] > 0
    ap = np.where(pulse_voiced[:, None], ap, 1.0)
    ap = np.clip(ap, 1e-6, 1.0 - 1e-12)
    period = fs / rate[pulse_pos]

    out_fft = fft_size * 2
    eps = 1e-30
    periodic_power = np.log(sp * (1.0 - ap**2) + eps)
    h_per = _min_phase_ir_np(periodic_power, fft_size, out_fft)
    amp = np.where(pulse_voiced, np.sqrt(period), 0.0)
    resp = np.fft.irfft(h_per, n=out_fft, axis=-1) * amp[:, None]

    aperiodic_power = np.log(sp * ap**2 + eps)
    h_ap = _min_phase_ir_np(aperiodic_power, fft_size, out_fft)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((len(pulse_pos), fft_size))
    seg_mask = np.arange(fft_size)[None, :] < np.ceil(period)[:, None]
    noise_spec = np.fft.rfft(noise * seg_mask, n=out_fft, axis=-1)
    resp = resp + np.fft.irfft(noise_spec * h_ap, n=out_fft, axis=-1)

    # overlap-add
    out = np.zeros(out_len + out_fft, np.float64)
    for k, pos in enumerate(pulse_pos):
        out[pos:pos + out_fft] += resp[k]
    return out[:out_len].astype(np.float32)
