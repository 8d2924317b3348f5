"""Mel-cepstrum transform matrices (SPTK-compatible freqt), numpy.

A copy of ``voice100_tpu/dsp/mcep.py:22-79`` (the reference builds both
maps at voice100/vocoder.py:105-141): each direction is linear, so it is
materialized once, by running the all-pass warping recurrence on unit
vectors, and applied as one matmul a clip or a batch.

sp2mc: log-spectrum ``[.., n_fft//2+1] @ sp2mc`` -> mel-cepstrum ``[.., order+1]``
mc2sp: mel-cepstrum ``@ mc2sp`` -> log-spectrum
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["freqt_matrix", "create_sp2mc_matrix", "create_mc2sp_matrix"]


def freqt_matrix(in_order: int, out_order: int, alpha: float) -> np.ndarray:
    """``A [in_order+1, out_order+1]`` with ``ceps @ A`` equal to
    ``freqt(ceps, out_order, alpha)`` for row cepstra."""
    return _freqt_apply(np.eye(in_order + 1), out_order, alpha)


def _freqt_apply(ceps: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """The freqt recurrence on a batch of row cepstra (pysptk.freqt
    semantics: coefficients consumed from the highest index down, each
    step an all-pass lattice update)."""
    rows, width = ceps.shape
    c = np.zeros((rows, order + 1))
    one_minus_a2 = 1.0 - alpha * alpha
    for i in range(width):
        d = alpha * c
        d[:, 0] += ceps[:, width - 1 - i]
        if order >= 1:
            d[:, 1] += one_minus_a2 * c[:, 0]
        for j in range(2, order + 1):
            d[:, j] += c[:, j - 1] - alpha * d[:, j - 1]
        c = d
    return c


@lru_cache(maxsize=8)
def _matrices(fftlen: int, order: int, alpha: float):
    n_freq = fftlen // 2 + 1
    # sp2mc: irfft of each unit log-spectrum row -> halve c0 -> warp
    c = np.fft.irfft(np.eye(n_freq))  # [n_freq, fftlen]
    c[:, 0] /= 2.0
    sp2mc = _freqt_apply(c, order, alpha)
    # mc2sp: unwarp unit mel-cepstra -> double c0 -> mirror -> rfft.real
    u = _freqt_apply(np.eye(order + 1), fftlen // 2, -alpha)
    u[:, 0] *= 2.0
    full = np.concatenate([u, u[:, :0:-1]], axis=1)
    mc2sp = np.fft.rfft(full).real
    for m in (sp2mc, mc2sp):
        m.flags.writeable = False
    return sp2mc, mc2sp


def create_sp2mc_matrix(fftlen: int, order: int, alpha: float) -> np.ndarray:
    """``[n_fft//2+1, order+1]`` log-spectrum -> mel-cepstrum map, float64
    (read-only: one cached array serves every caller)."""
    return _matrices(fftlen, order, alpha)[0]


def create_mc2sp_matrix(fftlen: int, order: int, alpha: float) -> np.ndarray:
    """``[order+1, n_fft//2+1]`` mel-cepstrum -> log-spectrum map, float64
    (read-only)."""
    return _matrices(fftlen, order, alpha)[1]
