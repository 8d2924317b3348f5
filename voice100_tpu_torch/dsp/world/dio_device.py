"""F0 estimation on the device (batched torch float32, YIN/CMNDF family).

The counterpart of ``voice100_tpu/dsp/world/dio_jax.py``, the estimator
behind ``WORLDVocoder(analysis_backend="device")`` (alias ``"jax"``).
The host DIO (:mod:`.dio`) is built on data-dependent loops; this one is
a vectorized cumulative-mean-normalized difference function (YIN) over
framed audio with parabolic sub-sample refinement and a median-filtered,
voicing-consistent contour, every frame in one batch.

Output contract as ``dio.dio``: ``(f0 [T], positions [T])`` with
``f0 == 0`` on unvoiced frames, frames every ``frame_period`` ms. The
arithmetic is float32 throughout, as in the JAX package, and frame
starts round half to even (``torch.round`` and ``jnp.round`` agree;
Python's ``round`` of a float32 product would not be the same value).
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import const, uploader

__all__ = ["dio_device", "yin_f0", "dio_device_tensors"]


def yin_f0(x: torch.Tensor, fs: int, f0_floor: float = 80.0, f0_ceil: float = 400.0,
           frame_period: float = 10.0, n_frames: int = 0,
           threshold: float = 0.15) -> torch.Tensor:
    """Framed CMNDF F0 track ``[n_frames]`` of a float32 waveform; 0 where
    unvoiced (``dio_jax.py:36-129``)."""
    x = x.to(torch.float32)
    dev = x.device
    # fractional hop: an integer hop would drift the analyzed frame
    # centres from the reported positions where fs * frame_period is not
    # integral (22050 Hz)
    hop_f = fs * frame_period / 1000.0
    tau_min = max(int(fs / f0_ceil) - 1, 2)
    tau_max = int(np.ceil(fs / f0_floor)) + 1
    window = 2 * tau_max

    # centred frames: pad both sides so every frame is full
    pad = window
    xp = torch.nn.functional.pad(x, (pad, 2 * window))
    starts = (torch.round(torch.arange(n_frames, dtype=torch.int32, device=dev) * hop_f)
              .to(torch.int32) + (pad - tau_max))
    idx = starts[:, None] + torch.arange(window, device=dev)[None, :]
    frames = xp[idx]  # [T, W]
    frames = frames - frames.mean(dim=1, keepdim=True)

    # d[tau] = sum_{j<N} (x_j - x_{j+tau})^2, N = tau_max, by
    # d = P0 + P_tau - 2 xcorr (the cross-correlation through FFTs)
    taus = torch.arange(tau_max + 1, device=dev)
    a = frames[:, :tau_max]  # [T, N]
    p0 = (a * a).sum(dim=1, keepdim=True)
    csq = torch.cat([frames.new_zeros(n_frames, 1), torch.cumsum(frames * frames, dim=1)], dim=1)
    p_tau = csq[:, taus + tau_max] - csq[:, taus]  # [T, K]
    fft_len = 4 * tau_max  # >= N + tau_max: no circular wrap
    fa = torch.fft.rfft(a, n=fft_len, dim=1)
    fb = torch.fft.rfft(frames, n=fft_len, dim=1)
    xcorr = torch.fft.irfft(torch.conj(fa) * fb, n=fft_len, dim=1)
    diff = torch.clamp(p0 + p_tau - 2.0 * xcorr[:, :tau_max + 1], min=0.0)  # [T, K]

    # cumulative mean normalized difference
    cumsum = torch.cumsum(diff[:, 1:], dim=1)
    cmndf = torch.cat([diff.new_ones(n_frames, 1),
                       diff[:, 1:] * taus[1:][None, :] / torch.clamp(cumsum, min=1e-9)], dim=1)

    # the FIRST local minimum below the threshold within the band (a
    # global argmin would pick subharmonics), else the global minimum
    band = (taus >= tau_min) & (taus <= tau_max - 1)
    inf = torch.tensor(float("inf"), device=dev)
    banded = torch.where(band[None, :], cmndf, inf)
    prev = torch.nn.functional.pad(banded, (1, 0), value=float("inf"))[:, :-1]
    nxt = torch.nn.functional.pad(banded, (0, 1), value=float("inf"))[:, 1:]
    is_local_min = (banded <= prev) & (banded <= nxt)
    candidate = is_local_min & (banded < threshold)
    has_candidate = candidate.any(dim=1)
    first_candidate = torch.argmax(candidate.to(torch.uint8), dim=1)  # the first maximum
    global_min = torch.argmin(banded, dim=1)
    tau_star = torch.where(has_candidate, first_candidate, global_min)
    d_min = torch.gather(banded, 1, tau_star[:, None])[:, 0]

    # parabolic sub-sample interpolation around the minimum
    t0 = torch.clamp(tau_star - 1, 0, tau_max)
    t2 = torch.clamp(tau_star + 1, 0, tau_max)
    y0 = torch.gather(cmndf, 1, t0[:, None])[:, 0]
    y1 = d_min
    y2 = torch.gather(cmndf, 1, t2[:, None])[:, 0]
    denom = y0 - 2 * y1 + y2
    shift = torch.where(denom.abs() > 1e-9, 0.5 * (y0 - y2) / denom, 0.0)
    tau_ref = tau_star.to(torch.float32) + torch.clamp(shift, -1.0, 1.0)

    f0 = tau_ref.new_tensor(float(fs)) / torch.clamp(tau_ref, min=1.0)
    voiced = (d_min < threshold) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    return torch.where(voiced, f0, 0.0)


def _median3(f0: torch.Tensor) -> torch.Tensor:
    """The median of each frame and its two neighbours, edges repeated."""
    a = torch.cat([f0[:1], f0, f0[-1:]])
    return torch.stack([a[:-2], a[1:-1], a[2:]], dim=0).median(dim=0).values


def dio_device_tensors(x: torch.Tensor, fs: int, f0_floor: float = 80.0,
                       f0_ceil: float = 400.0, frame_period: float = 10.0):
    """``(f0, positions)``, float32 tensors on the waveform's device (the
    positions as the JAX package casts them): what ``encode`` keeps on
    the device between the estimators."""
    n_frames = int(x.shape[0] / fs * 1000.0 / frame_period) + 1
    f0 = _median3(yin_f0(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                         frame_period=frame_period, n_frames=n_frames))
    # a voiced frame between two unvoiced frames is noise
    v = f0 > 0
    vp = torch.cat([v.new_zeros(1), v, v.new_zeros(1)])
    isolated = v & ~vp[:-2] & ~vp[2:]
    f0 = torch.where(isolated, 0.0, f0)
    positions = const((np.arange(n_frames) * frame_period / 1000.0).astype(np.float32), x)
    return f0, positions


def dio_device(x, fs: int, f0_floor: float = 80.0, f0_ceil: float = 400.0,
               frame_period: float = 10.0, device=None):
    """Drop-in device counterpart of ``dio.dio`` (``dio_jax.py:138-163``):
    the waveform goes to ``device`` (default ``cuda``) as float32; returns
    float64 host ``(f0, positions)``."""
    f0, _ = dio_device_tensors(uploader(device)(x), fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                               frame_period=frame_period)
    n_frames = f0.shape[0]
    return (f0.cpu().numpy().astype(np.float64),
            np.arange(n_frames) * frame_period / 1000.0)

