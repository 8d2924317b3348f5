"""MP3 decoding via the native library (ctypes binding).

The native side dlopens the system libmpg123 — the framework's
equivalent of the reference's torchaudio/sox mp3 path used for the
CommonVoice (cv_ja) corpus (voice100/data_modules.py:303-314). A copy of
``voice100_tpu/native/mp3.py``: code 100 means libmpg123 is absent.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import get_lib

__all__ = ["read_mp3", "mp3_available"]


def mp3_available() -> bool:
    """True when the system MPEG decoder library can be loaded."""
    try:
        return bool(get_lib().v100_mp3_available())
    except ImportError:
        return False


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file -> (samples ``[channels, n]`` float32, rate)."""
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_float)()
    channels = ctypes.c_int()
    samples = ctypes.c_long()
    rate = ctypes.c_int()
    code = lib.v100_read_mp3(
        path.encode("utf-8"),
        ctypes.byref(out),
        ctypes.byref(channels),
        ctypes.byref(samples),
        ctypes.byref(rate),
    )
    if code == 100:
        raise RuntimeError(
            "MP3 decoding requires the system MPEG decoder library "
            "(libmpg123), which could not be loaded"
        )
    if code != 0:
        raise ValueError(f"MP3 decode failed for {path} (code {code})")
    try:
        n = channels.value * samples.value
        flat = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.v100_free(out)
    return flat.reshape(channels.value, samples.value), rate.value
