"""Audio file loading with rate conversion.

Port of ``voice100_tpu/dsp/audioio.py`` (the reference's torchaudio.load +
resample, voice100/data_modules.py:287-292,303-314): decode, take the
first channel, resample to the target rate.

WAV decodes in NumPy. FLAC and MP3 decode in the JAX package through its
native C++ decoders (``voice100_tpu/native/``), which the port has not
ported yet: for those files :func:`load_audio` raises
:class:`NotImplementedError` naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import os

import numpy as np

from .resample import resample
from .wav import read_wav

__all__ = ["load_audio", "NATIVE_DECODERS_ITEM"]

NATIVE_DECODERS_ITEM = "ROADMAP.md, queue 1, item 13 (data shell: native FLAC/MP3 decoders)"


def _read_any(path: str):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext in (".flac", ".mp3"):
        raise NotImplementedError(
            f"{path}: {ext[1:].upper()} decoding is not ported yet; the native decoders "
            f"(voice100_tpu/native/) wait for {NATIVE_DECODERS_ITEM}"
        )
    raise ValueError(f"Unsupported audio format: {path}")


def load_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Load an audio file -> mono float32 ``[T]`` at ``sample_rate``.

    Channel policy matches sox ``remix 1`` (first channel) and
    torchaudio's ``waveform[0]`` (voice100/data_modules.py:289,303-315).
    """
    samples, rate = _read_any(path)
    mono = samples[0] if samples.ndim == 2 else samples
    if rate != sample_rate:
        mono = resample(mono, rate, sample_rate)
    return np.asarray(mono, dtype=np.float32)
