"""FLAC decoding via the native library (ctypes binding).

A copy of ``voice100_tpu/native/flac.py``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import get_lib

__all__ = ["read_flac"]


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (samples ``[channels, n]`` float32, rate)."""
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_float)()
    channels = ctypes.c_int()
    samples = ctypes.c_long()
    rate = ctypes.c_int()
    code = lib.v100_read_flac(
        path.encode("utf-8"),
        ctypes.byref(out),
        ctypes.byref(channels),
        ctypes.byref(samples),
        ctypes.byref(rate),
    )
    if code != 0:
        raise ValueError(f"FLAC decode failed for {path} (code {code})")
    try:
        n = channels.value * samples.value
        flat = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.v100_free(out)
    return flat.reshape(channels.value, samples.value), rate.value
