"""DIO-style F0 estimation (vectorized host NumPy, float64).

A copy of ``voice100_tpu/dsp/world/dio.py``, which imports nothing but
NumPy, so that the port reads WAVs into WORLD features without the JAX
package: the same code on the same float64 input gives the same F0
contour bit for bit. The algorithm is the DIO family the reference uses
through pyworld (voice100/vocoder.py:67-69): a bank of Nuttall-windowed
low-pass filters at log-spaced boundary frequencies, four interval-based
F0 candidates a band (rising and falling zero crossings, peaks, dips),
stability-scored candidate selection, and contour fixing (jump removal,
short-segment pruning, candidate re-selection). Output: ``f0 == 0`` on
unvoiced frames, temporal positions at the frame period.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["dio"]


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) * 2.0 * np.pi / (n - 1)
    return (
        0.355768
        - 0.487396 * np.cos(t)
        + 0.144232 * np.cos(2 * t)
        - 0.012604 * np.cos(3 * t)
    )


def _lowpass(spectrum: np.ndarray, fs: int, n: int, boundary_f0: float) -> np.ndarray:
    """Filter the signal (given its rfft) with a Nuttall-window LPF whose
    main lobe passes ~boundary_f0."""
    half_len = int(round(fs / boundary_f0 / 2.0 + 0.5))
    kernel = _nuttall(half_len * 4)
    kernel = kernel / kernel.sum()
    k = np.fft.rfft(kernel, n=n)
    filtered = np.fft.irfft(spectrum * k, n=n)
    # compensate the filter group delay (linear phase, center of kernel)
    delay = len(kernel) // 2
    return np.roll(filtered, -delay)


def _event_intervals(flags: np.ndarray, signal: np.ndarray, fs: int):
    """Interval-based F0 observations from sign-change events.

    Args:
        flags: boolean array; True where an event occurs between i, i+1.
        signal: the filtered signal (for sub-sample interpolation).
    Returns (locations_sec, f0_values) arrays (possibly empty).
    """
    idx = np.nonzero(flags)[0]
    if idx.size < 2:
        return np.empty(0), np.empty(0)
    denom = signal[idx + 1] - signal[idx]
    frac = np.where(np.abs(denom) > 1e-12, -signal[idx] / denom, 0.5)
    times = (idx + np.clip(frac, 0.0, 1.0)) / fs
    intervals = np.diff(times)
    good = intervals > 1e-6
    f0 = np.where(good, 1.0 / np.maximum(intervals, 1e-6), 0.0)
    locations = (times[:-1] + times[1:]) / 2.0
    return locations[good], f0[good]


def _four_candidates(filtered: np.ndarray, fs: int, positions: np.ndarray):
    """Interpolate the four interval-based estimates to frame times."""
    x = filtered
    d = np.diff(x)
    events = [
        (x[:-1] < 0) & (x[1:] >= 0),        # rising zero crossings
        (x[:-1] >= 0) & (x[1:] < 0),        # falling zero crossings
        (d[:-1] < 0) & (d[1:] >= 0),        # dips (on derivative)
        (d[:-1] >= 0) & (d[1:] < 0),        # peaks (on derivative)
    ]
    signals = [x, -x, d, -d]
    out = np.zeros((4, positions.shape[0]))
    for j, (flags, sig) in enumerate(zip(events, signals)):
        locs, f0s = _event_intervals(flags[: len(sig) - 1], sig, fs)
        if locs.size >= 2:
            est = np.interp(positions, locs, f0s)
            inside = (positions >= locs[0]) & (positions <= locs[-1])
            out[j] = np.where(inside, est, 0.0)
    return out


def _select_best_f0(
    current_f0: float,
    past_f0: float,
    candidates: np.ndarray,
    frame: int,
    allowed_range: float,
) -> float:
    """WORLD's SelectBestF0 (dio.cpp): pick the band candidate closest
    to the half-step linear extrapolation; reject if the relative error
    exceeds allowed_range."""
    reference = (current_f0 * 3.0 - past_f0) / 2.0
    if reference <= 0.0:
        return 0.0
    cands = candidates[:, frame]
    best = cands[np.argmin(np.abs(reference - cands))]
    if abs(1.0 - best / reference) > allowed_range:
        return 0.0
    return float(best)


def _voiced_sections(f0: np.ndarray):
    """(starts, ends): first voiced frame of each section, last voiced
    frame of each section (WORLD's GetNumberOfVoicedSections)."""
    voiced = (f0 > 0).astype(np.int8)
    d = np.diff(voiced)
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1))
    if voiced[0]:
        starts.insert(0, 0)
    if voiced[-1]:
        ends.append(len(f0) - 1)
    return starts, ends


def _fix_contour(
    f0: np.ndarray,
    candidates: np.ndarray,
    allowed_range: float,
    voice_range_minimum: int,
) -> np.ndarray:
    """WORLD's FixF0Contour (dio.cpp FixStep1-4).

    Step 1 zeroes frames whose relative F0 jump exceeds allowed_range;
    step 2 prunes voiced runs shorter than voice_range_minimum with a
    sliding all-voiced window; steps 3/4 then re-grow the conservative
    contour forward from each section end and backward from each
    section start, selecting per-band candidates consistent with the
    local linear extrapolation (SelectBestF0).
    """
    n = len(f0)

    # FixStep1: suppress unnatural frame-to-frame change
    step1 = np.zeros_like(f0)
    for i in range(voice_range_minimum, n):
        if f0[i] == 0.0:
            continue
        if abs((f0[i] - f0[i - 1]) / (1e-10 + f0[i])) < allowed_range:
            step1[i] = f0[i]

    # FixStep2: a frame survives only if its whole window is voiced
    step2 = step1.copy()
    center = (voice_range_minimum - 1) // 2
    if center > 0 and n > 2 * center:
        voiced = step1 > 0
        window_ok = np.lib.stride_tricks.sliding_window_view(
            voiced, 2 * center + 1
        ).all(axis=1)
        step2[center:n - center] = np.where(
            window_ok, step1[center:n - center], 0.0
        )

    if not np.any(step2 > 0):
        return step2

    starts, ends = _voiced_sections(step2)

    # FixStep3: extend each voiced section forward from its end
    step3 = step2.copy()
    for k, end in enumerate(ends):
        limit = (starts[k + 1] - 1) if k + 1 < len(starts) else n - 1
        j = end
        while j < limit:
            nxt = _select_best_f0(
                step3[j], step3[j - 1] if j > 0 else step3[j],
                candidates, j + 1, allowed_range,
            )
            step3[j + 1] = nxt
            if nxt == 0.0:
                break
            j += 1

    # FixStep4: extend each voiced section backward from its start
    step4 = step3.copy()
    for k in range(len(starts) - 1, -1, -1):
        start = starts[k]
        limit = (ends[k - 1] + 1) if k > 0 else 0
        j = start
        while j > limit:
            prev = _select_best_f0(
                step4[j], step4[j + 1] if j + 1 < n else step4[j],
                candidates, j - 1, allowed_range,
            )
            step4[j - 1] = prev
            if prev == 0.0:
                break
            j -= 1
    return step4


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 80.0,
    f0_ceil: float = 400.0,
    frame_period: float = 10.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate (f0, temporal_positions); f0 == 0 marks unvoiced frames.

    API parity with pyworld.dio as used by the reference
    (voice100/vocoder.py:67-69).
    """
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    positions = np.arange(n_frames) * frame_period / 1000.0

    n_bands = int(
        np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    ) + 1
    boundary_f0s = f0_floor * 2.0 ** (
        (np.arange(n_bands) + 1) / channels_in_octave
    )

    n_fft = int(2 ** np.ceil(np.log2(len(x) + fs)))  # room for kernels
    spectrum = np.fft.rfft(x, n=n_fft)
    # low-cut below ~f0_floor/2 (WORLD's low-cut filter): DC and drift
    # would otherwise bias the zero-crossing interval candidates
    freqs = np.arange(spectrum.shape[0]) * fs / n_fft
    cutoff = f0_floor * 0.5
    rolloff = np.clip((freqs - cutoff * 0.5) / (cutoff * 0.5), 0.0, 1.0)
    spectrum = spectrum * rolloff

    all_candidates = np.zeros((n_bands, n_frames))
    all_scores = np.full((n_bands, n_frames), np.inf)
    for b, boundary in enumerate(boundary_f0s):
        filtered = _lowpass(spectrum, fs, n_fft, boundary)[: len(x)]
        four = _four_candidates(filtered, fs, positions)
        valid = (four > 0).all(axis=0)
        mean = four.mean(axis=0)
        dev = np.sqrt(((four - mean[None, :]) ** 2).mean(axis=0))
        score = np.where(mean > 0, dev / np.maximum(mean, 1e-9), np.inf)
        ok = (
            valid
            & (mean >= max(boundary / 2.0, f0_floor))
            & (mean <= min(boundary * 1.1, f0_ceil) + 1e-9)
            & (mean >= f0_floor)
        )
        all_candidates[b] = np.where(ok, mean, 0.0)
        all_scores[b] = np.where(ok, score, np.inf)

    best = np.argmin(all_scores, axis=0)
    cols = np.arange(n_frames)
    f0 = all_candidates[best, cols]
    best_score = all_scores[best, cols]
    # reject unstable candidates (interval estimates disagree)
    f0 = np.where(best_score < 0.15, f0, 0.0)

    # WORLD's voice_range_minimum (dio.cpp FixF0Contour)
    voice_range_minimum = (
        int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1
    )
    f0 = _fix_contour(
        f0, all_candidates, allowed_range, voice_range_minimum
    )
    return f0, positions
