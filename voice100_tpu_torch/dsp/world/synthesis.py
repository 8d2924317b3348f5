"""WORLD waveform synthesis as batched PyTorch code.

Port of ``voice100_tpu/dsp/world/synthesis.py`` ``synthesize_fn`` with an
explicit leading batch axis in place of ``vmap``; the reference
synthesizes with pyworld one utterance at a time on the host
(voice100/vocoder.py:100-101). The same pitch-synchronous overlap-add
model, in the same design:

* per-sample F0 is interpolated from frames (the integer-hop repeat and
  the fractional-hop gather, 22.05 kHz); unvoiced spans pulse at 200 Hz
  with a fully aperiodic mix; pulses sit where the cumulative phase
  wraps, compacted one a chunk of samples (a chunk is shorter than the
  shortest period);
* each pulse's periodic response is the minimum-phase impulse response of
  ``sqrt(sp * (1 - ap^2))``, scaled by ``sqrt(period)``; the aperiodic one
  is white noise over one period shaped by ``sqrt(sp * ap^2)``;
* every DFT is a matmul against precomputed Fourier matrices: the
  cepstral min-phase chain folds into one complex matrix on the log
  power; the pulse's sub-block offset is an exact integer phase twist
  ``(k * off) mod 3n`` on a 3n-point grid; pulses of a block are summed
  by a one-hot ``[blocks, pulses]`` matmul and one inverse DFT runs a
  block; three block-aligned segments recombine by slices.

These are plain matrix products outside any TPU kernel, so they are
``torch.matmul`` here, in float32 with TF32 off (as ``Precision.HIGHEST``;
:func:`voice100_tpu_torch.device.resolve_device` turns TF32 off).

Reference behaviour that no port reproduces, and what this one does:

* **Noise.** JAX draws it with threefry from ``jax.random.split(
  PRNGKey(0), B)``, which torch cannot reproduce. Here it comes from an
  explicit ``torch.Generator`` (seeded 0 by default), or the caller passes
  the noise tensor itself (the tests feed JAX's draws).
* **Pulse phase.** JAX takes a float32 ``jnp.cumsum`` of the phase
  increments over every output sample; its rounding depends on XLA's
  summation order, which no port can match (over 20 s, float32 sums in two
  orders part by up to 6e-4 cycles). Here the per-sample rate is float64
  and the phase an exact integer prefix sum: each sample's rate is rounded
  to a multiple of 2^-24 Hz (every float32 F0 in [32, 512) Hz is one), and
  a pulse falls where the running sum of those rates passes a multiple of
  ``fs``. Integer sums do not depend on their order, so the card and the
  CPU place every pulse alike, and a phase that lands exactly on a whole
  cycle (a 200 Hz unvoiced span from the start of an utterance: every 80
  samples at 16 kHz) wraps there, as exact arithmetic does. Against JAX,
  about 1% of the pulses of a 10-20 s utterance move by one sample,
  within the error of JAX's own float32 sum, and so may pulses where JAX's
  phase meets a whole cycle exactly (its rounding then decides); on
  voiced utterances under a second they agree.
* **Scatter.** ``.at[slot].set(mode="drop")`` drops out-of-range slots;
  torch's scatter raises on them, so they go to a spare column instead.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["synthesis_shape", "synthesize_batch"]

_DEFAULT_F0 = 200.0  # pulse rate used to tile noise in unvoiced spans
_MAX_RATE = 420.0    # a touch above the 400 Hz f0 ceiling
_MIN_RATE = 40.0
_RATE_BITS = 24      # the phase's fixed point: rates in units of 2^-24 Hz

NoiseSource = Union[None, torch.Generator, torch.Tensor]


@lru_cache(maxsize=4)
def _dft_consts(fft_size: int) -> Dict[str, np.ndarray]:
    """Fourier matrices (float32 numpy, exact float64 construction) at
    envelope FFT size ``n``, as ``voice100_tpu/dsp/world/synthesis.py``
    ``_dft_consts`` builds them:

    * ``At_r/At_i [F, F]``: log-power half-spectrum -> min-phase log
      frequency response (the cepstral lifter chain and the 0.5 factor),
    * ``Bt_r/Bt_i [F, n]``: complex half-spectrum -> real IR (irfft_n),
    * ``Ct_r/Ct_i [n, Fe]``: real n-signal -> half-spectrum on the 3n grid,
    * ``Dt_r/Dt_i [Fe, 3n]``: half-spectrum on the 3n grid -> real signal.
    """
    n = fft_size
    F = n // 2 + 1
    ext = 3 * n
    Fe = ext // 2 + 1
    k = np.arange(F)
    nn = np.arange(n)
    c = np.where((k == 0) | (k == n // 2), 1.0, 2.0)
    W = (c[None, :] * np.cos(2 * np.pi * k[None, :] * nn[:, None] / n)) / n
    lift = np.concatenate([np.ones(1), 2.0 * np.ones(n // 2 - 1), np.ones(1),
                           np.zeros(n // 2 - 1)])
    R = np.exp(-2j * np.pi * k[:, None] * nn[None, :] / n)
    A = 0.5 * (R * lift[None, :]) @ W  # [F, F] complex
    Bt_r = (c[:, None] * np.cos(2 * np.pi * k[:, None] * nn[None, :] / n)) / n
    Bt_i = (-c[:, None] * np.sin(2 * np.pi * k[:, None] * nn[None, :] / n)) / n
    k2 = np.arange(Fe)
    Ct_r = np.cos(2 * np.pi * nn[:, None] * k2[None, :] / ext)
    Ct_i = -np.sin(2 * np.pi * nn[:, None] * k2[None, :] / ext)
    c2 = np.where((k2 == 0) | (k2 == ext // 2), 1.0, 2.0)
    m = np.arange(ext)
    Dt_r = (c2[:, None] * np.cos(2 * np.pi * k2[:, None] * m[None, :] / ext)) / ext
    Dt_i = (-c2[:, None] * np.sin(2 * np.pi * k2[:, None] * m[None, :] / ext)) / ext
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return dict(At_r=f32(A.real.T), At_i=f32(A.imag.T), Bt_r=f32(Bt_r), Bt_i=f32(Bt_i),
                Ct_r=f32(Ct_r), Ct_i=f32(Ct_i), Dt_r=f32(Dt_r), Dt_i=f32(Dt_i))


_DEVICE_CONSTS: Dict[Tuple[int, str], Dict[str, torch.Tensor]] = {}


def _consts(fft_size: int, device: torch.device) -> Dict[str, torch.Tensor]:
    key = (fft_size, str(device))
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = {k: torch.from_numpy(v).to(device)
                               for k, v in _dft_consts(fft_size).items()}
    return _DEVICE_CONSTS[key]


def synthesis_shape(n_frames: int, fs: int, frame_period: float,
                    fft_size: int) -> Tuple[int, int]:
    """``(out_len, max_pulses)`` of ``n_frames`` frames: samples
    ``round((T - 1) * hop) + 1`` (the total rounded, not each frame, so a
    fractional hop keeps the duration) and the static pulse capacity of the
    densest train; the noise is ``[B, max_pulses, fft_size]``."""
    out_len = int(round((n_frames - 1) * fs * frame_period / 1000.0)) + 1
    max_pulses = int(out_len / fs * max(_MAX_RATE, _DEFAULT_F0)) + 8
    return out_len, max_pulses


def _per_sample_f0(f0: torch.Tensor, hop: float, out_len: int) -> torch.Tensor:
    """``[B, T]`` frame F0 -> ``[B, out_len]`` float64 per-sample F0, linear
    between voiced frames, held into a voiced frame's unvoiced neighbour,
    zero between unvoiced frames."""
    n_frames = f0.shape[1]
    f0 = f0.to(torch.float64)
    device = f0.device
    if hop == int(hop):
        # integer hop: the frame-index pattern repeats every hop samples
        H = int(hop)
        reps = (out_len + H - 1) // H
        idx = torch.arange(reps, device=device)
        f0_a = f0[:, idx.clamp(max=n_frames - 1)][:, :, None]
        f0_b = f0[:, (idx + 1).clamp(max=n_frames - 1)][:, :, None]
        w = (torch.arange(H, device=device, dtype=torch.float64) * (1.0 / hop))[None, None, :]
    else:
        # by the reciprocal: the CPU and CUDA multiply alike, where a
        # tensor division by a scalar takes the reciprocal on CUDA only
        sample_pos = torch.arange(out_len, device=device, dtype=torch.float64) * (1.0 / hop)
        fr0 = sample_pos.floor().to(torch.int64).clamp(0, n_frames - 1)
        fr1 = (fr0 + 1).clamp(max=n_frames - 1)
        f0_a, f0_b = f0[:, fr0], f0[:, fr1]
        w = (sample_pos - fr0)[None, :]
    voiced_a, voiced_b = f0_a > 0, f0_b > 0
    out = torch.where(voiced_a & voiced_b, f0_a * (1 - w) + f0_b * w,
                      torch.where(voiced_a, f0_a, torch.where(voiced_b, f0_b, 0.0)))
    return out.reshape(f0.shape[0], -1)[:, :out_len]


def _pulse_positions(rate: torch.Tensor, fs: int, max_pulses: int) -> torch.Tensor:
    """``[B, out_len]`` float64 rates (Hz) -> ``[B, max_pulses]`` int64
    sample positions where the cumulative phase wraps (-1 past the last),
    by an exact integer prefix sum of the rates in units of 2^-24 Hz."""
    batch, out_len = rate.shape
    device = rate.device
    steps = torch.round(rate * float(1 << _RATE_BITS)).to(torch.int64)
    wraps = torch.cumsum(steps, dim=1) // (fs << _RATE_BITS)
    is_pulse = torch.cat([torch.ones(batch, 1, dtype=torch.bool, device=device),
                          (wraps[:, 1:] - wraps[:, :-1]) >= 1], dim=1)
    # at most one pulse a chunk: a chunk is shorter than the shortest period
    C = min(32, int(fs / _MAX_RATE))
    n_chunks = (out_len + C - 1) // C
    chunks = torch.nn.functional.pad(is_pulse, (0, n_chunks * C - out_len)).reshape(
        batch, n_chunks, C).to(torch.uint8)
    has = chunks.amax(dim=2) > 0
    first = chunks.argmax(dim=2)  # the first maximum, as jnp.argmax
    cpos = torch.arange(n_chunks, device=device) * C + first
    rank = torch.cumsum(has.to(torch.int64), dim=1)
    # JAX drops slots past the capacity; here they land in a spare column
    slot = torch.where(has & (rank <= max_pulses), rank - 1, max_pulses)
    pos = torch.full((batch, max_pulses + 1), -1, dtype=torch.int64, device=device)
    pos.scatter_(1, slot, torch.where(slot < max_pulses, cpos, -1))
    return pos[:, :max_pulses]


def _noise(noise: NoiseSource, shape, device: torch.device) -> torch.Tensor:
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise must be {tuple(shape)}, got {tuple(noise.shape)}")
        return noise.to(device=device, dtype=torch.float32)
    if noise is None:
        noise = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=noise, device=noise.device).to(device)


def synthesize_batch(f0: torch.Tensor, spectrogram: torch.Tensor, aperiodicity: torch.Tensor,
                     fs: int = 16000, frame_period: float = 10.0,
                     noise: NoiseSource = None) -> torch.Tensor:
    """WORLD features -> waveforms, on the device of ``f0``.

    ``f0 [B, T]`` Hz (0 unvoiced), ``spectrogram [B, T, F]`` power envelope,
    ``aperiodicity [B, T, F]`` amplitude ratio, float32 -> ``[B, out_len]``
    float32 with ``out_len = round((T - 1) * hop) + 1``. ``noise``: the
    aperiodic excitation ``[B, max_pulses, F*2-2]`` (:func:`synthesis_shape`),
    or a ``torch.Generator`` to draw it from (on the generator's device),
    or None for a generator seeded 0 on ``f0``'s device."""
    device = f0.device
    f0 = f0.to(torch.float32)
    spectrogram = spectrogram.to(device=device, dtype=torch.float32)
    aperiodicity = aperiodicity.to(device=device, dtype=torch.float32)
    batch, n_frames = f0.shape
    n = (spectrogram.shape[2] - 1) * 2
    ext = 3 * n
    out_len, max_pulses = synthesis_shape(n_frames, fs, frame_period, n)
    hop = fs * frame_period / 1000.0
    M = _consts(n, device)

    f0_interp64 = _per_sample_f0(f0, hop, out_len)
    rate64 = torch.where(f0_interp64 > 0, f0_interp64, _DEFAULT_F0).clamp(_MIN_RATE, _MAX_RATE)
    pulse_pos = _pulse_positions(rate64, fs, max_pulses)
    valid = pulse_pos >= 0
    safe_pos = pulse_pos.clamp(min=0)

    # per-pulse envelope and voicing (frame interpolation), float32 as in JAX.
    # A quotient is taken in float64 and rounded once to float32, which is
    # JAX's correctly rounded float32 quotient: torch divides a CUDA tensor
    # by a scalar through its reciprocal, an ulp off, and where the
    # aperiodicity is ~1, 1 - ap^2 turns an ulp of pw into a visible change
    rate = rate64.gather(1, safe_pos)
    pulse_voiced = f0_interp64.gather(1, safe_pos) > 0
    p_frame = (safe_pos.to(torch.float64) / hop).to(torch.float32)
    pf0 = p_frame.floor().to(torch.int64).clamp(0, n_frames - 1)
    pf1 = (pf0 + 1).clamp(max=n_frames - 1)
    pw = (p_frame - pf0)[:, :, None]

    def frames(x, idx):
        return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))

    sp = frames(spectrogram, pf0) * (1 - pw) + frames(spectrogram, pf1) * pw  # [B, P, F]
    ap = frames(aperiodicity, pf0) * (1 - pw) + frames(aperiodicity, pf1) * pw
    ap = torch.where(pulse_voiced[:, :, None], ap, 1.0).clamp(1e-6, 1.0 - 1e-12)
    period = (fs / rate).to(torch.float32)

    eps = 1e-30
    # min-phase IRs of both excitation paths in one stacked product
    lp = torch.cat([torch.log(sp * (1.0 - ap ** 2) + eps),
                    torch.log(sp * ap ** 2 + eps)], dim=1)  # [B, 2P, F]
    logHr = lp @ M["At_r"]
    logHi = lp @ M["At_i"]
    mag = torch.exp(logHr)
    ir = (mag * torch.cos(logHi)) @ M["Bt_r"] + (mag * torch.sin(logHi)) @ M["Bt_i"]  # [B, 2P, n]
    amp = torch.where(pulse_voiced, torch.sqrt(period), 0.0)
    rows = torch.cat([ir[:, :max_pulses] * amp[:, :, None], ir[:, max_pulses:]], dim=1)
    Er = rows @ M["Ct_r"]
    Ei = rows @ M["Ct_i"]
    Epr, Eapr = Er[:, :max_pulses], Er[:, max_pulses:]
    Epi, Eapi = Ei[:, :max_pulses], Ei[:, max_pulses:]

    # aperiodic excitation: white noise over one period
    noise = _noise(noise, (batch, max_pulses, n), device)
    seg_mask = torch.arange(n, device=device)[None, None, :] < torch.ceil(period)[:, :, None]
    noise = noise * seg_mask
    Nr = noise @ M["Ct_r"]
    Ni = noise @ M["Ct_i"]
    Xr = Epr + Nr * Eapr - Ni * Eapi
    Xi = Epi + Nr * Eapi + Ni * Eapr

    # placement: pos = blk * n + off; the off shift is an exact integer
    # phase twist, and a response never wraps ((n-1) + 2n-1 < 3n)
    blk = safe_pos // n
    off = safe_pos - blk * n
    kk = torch.arange(ext // 2 + 1, device=device)
    ang = (2.0 * np.pi / ext) * ((kk[None, None, :] * off[:, :, None]) % ext).to(torch.float32)
    ctw, stw = torch.cos(ang), torch.sin(ang)
    Xtr = Xr * ctw + Xi * stw
    Xti = Xi * ctw - Xr * stw

    # per-block sums as a one-hot product (invalid pulses match no block),
    # then one inverse DFT a block
    n_blocks = (out_len + n - 1) // n
    onehot = ((blk[:, :, None] == torch.arange(n_blocks, device=device)[None, None, :])
              & valid[:, :, None]).to(torch.float32).transpose(1, 2)  # [B, NB, P]
    y = (onehot @ Xtr) @ M["Dt_r"] + (onehot @ Xti) @ M["Dt_i"]  # [B, NB, 3n]

    flat = torch.zeros(batch, n_blocks + 3, n, device=device)
    for j in range(3):
        flat[:, j:j + n_blocks] += y[:, :, j * n:(j + 1) * n]
    return flat.reshape(batch, -1)[:, :out_len]
