"""Mel-cepstrum -> log-spectrum matrix (SPTK-compatible freqt), numpy.

A copy of what ``create_mc2sp_matrix`` needs from
``voice100_tpu/dsp/mcep.py`` (the reference builds it at
voice100/vocoder.py:115-141): the map is linear, so it is materialized
once, by running the all-pass warping recurrence on unit vectors, and
applied on the device as one matmul a batch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["create_mc2sp_matrix"]


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
def _mc2sp(fftlen: int, order: int, alpha: float) -> np.ndarray:
    # unwarp unit mel-cepstra -> double c0 -> mirror -> rfft.real
    u = _freqt_apply(np.eye(order + 1), fftlen // 2, -alpha)
    u[:, 0] *= 2.0
    full = np.concatenate([u, u[:, :0:-1]], axis=1)
    mc2sp = np.fft.rfft(full).real
    mc2sp.flags.writeable = False
    return mc2sp


def create_mc2sp_matrix(fftlen: int, order: int, alpha: float) -> np.ndarray:
    """``[order+1, n_fft//2+1]`` mel-cepstrum -> log-spectrum map, float64
    (read-only: one cached array serves every caller)."""
    return _mc2sp(fftlen, order, alpha)
