"""Thread-pool batch audio decode (ctypes binding).

One call decodes a whole batch of wav/flac/mp3 files on a C++ thread
pool (the GIL is released for the duration), each mixed down to the
first channel and resampled to the target rate — the native equivalent
of torch DataLoader's multi-worker decode (reference
voice100/data_modules.py:628-666). A copy of
``voice100_tpu/native/batch.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from . import get_lib

__all__ = ["load_audio_batch"]


def load_audio_batch(
    paths: Sequence[str],
    sample_rate: int = 16000,
    n_threads: int = 0,
) -> List[Optional[np.ndarray]]:
    """Decode files -> list of mono float32 arrays at ``sample_rate``.

    A file that fails to decode yields ``None`` in its slot (callers
    decide whether to fall back or raise); ``n_threads=0`` uses the
    hardware concurrency.
    """
    lib = get_lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(
        *[p.encode("utf-8") for p in paths]
    )
    outputs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_long * n)()
    rcs = (ctypes.c_int * n)()
    lib.v100_read_audio_batch(
        ctypes.cast(c_paths, ctypes.POINTER(ctypes.c_char_p)),
        n, sample_rate, n_threads,
        ctypes.cast(outputs, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_long)),
        ctypes.cast(rcs, ctypes.POINTER(ctypes.c_int)),
    )
    results: List[Optional[np.ndarray]] = []
    for i in range(n):
        if rcs[i] != 0 or not outputs[i]:
            results.append(None)
            continue
        try:
            arr = np.ctypeslib.as_array(
                outputs[i], shape=(lens[i],)
            ).copy()
        finally:
            lib.v100_free(outputs[i])
        results.append(arr)
    return results
