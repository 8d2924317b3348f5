"""Native WORLD synthesis (ctypes binding).

Port of ``voice100_tpu/native/world.py``: ``world.cpp`` (a copy of the
JAX package's), built into the native library with ``audioio.cpp``, is
the C++ counterpart of :mod:`voice100_tpu_torch.dsp.world.synthesis_np`
for native serving stacks; the reference gets synthesis from pyworld's
C++ (voice100/vocoder.py:100-101).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib

__all__ = ["synthesize_native"]


def synthesize_native(
    f0: np.ndarray,
    spectrogram: np.ndarray,
    aperiodicity: np.ndarray,
    fs: int = 16000,
    frame_period: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """(f0 [T], power envelope [T, nh], aperiodicity [T, nh]) -> mono
    float32 waveform. nh - 1 must be a power of two (fft size)."""
    lib = get_lib()
    f0 = np.ascontiguousarray(f0, np.float64)
    spc = np.ascontiguousarray(spectrogram, np.float64)
    ap = np.ascontiguousarray(aperiodicity, np.float64)
    if spc.ndim != 2 or ap.shape != spc.shape or f0.ndim != 1:
        raise ValueError(
            f"shape mismatch: f0 {f0.shape}, spectrogram {spc.shape}, "
            f"aperiodicity {ap.shape}"
        )
    if f0.shape[0] != spc.shape[0]:
        raise ValueError(
            f"f0 has {f0.shape[0]} frames, spectrogram {spc.shape[0]}"
        )
    if spc.shape[0] < 1:
        raise ValueError("need at least one frame")
    n_frames, nh = spc.shape
    out = ctypes.POINTER(ctypes.c_float)()
    out_n = ctypes.c_long()
    code = lib.v100_world_synthesize(
        f0.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        spc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ap.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_frames, nh, fs, float(frame_period), int(seed),
        ctypes.byref(out), ctypes.byref(out_n),
    )
    if code != 0:
        raise ValueError(f"native synthesis failed (code {code})")
    try:
        wav = np.ctypeslib.as_array(out, shape=(out_n.value,)).copy()
    finally:
        lib.v100_free(out)
    return wav
