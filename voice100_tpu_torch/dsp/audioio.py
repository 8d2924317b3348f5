"""Audio file loading with rate conversion.

Port of ``voice100_tpu/dsp/audioio.py`` (the reference's torchaudio.load +
resample, voice100/data_modules.py:287-292,303-314): decode, take the
first channel, resample to the target rate.

WAV decodes in NumPy. FLAC and MP3 decode through the port's native C++
library (``voice100_tpu_torch/native/``, built with g++ on first use);
where it cannot be built or loaded they raise ``RuntimeError`` naming
the file and the reason.
"""

from __future__ import annotations

import os

import numpy as np

from .resample import resample
from .wav import read_wav

__all__ = ["load_audio"]


def _read_any(path: str):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        try:
            from ..native import flac  # C++ decoder, built on demand

            return flac.read_flac(path)
        except ImportError as e:
            raise RuntimeError(
                f"{path}: FLAC decoding requires the native extension "
                f"(voice100_tpu_torch.native): {e}"
            ) from e
    if ext == ".mp3":
        # CommonVoice (cv_ja) clips; reference decodes them through
        # torchaudio/sox (voice100/data_modules.py:303-314)
        try:
            from ..native import mp3

            return mp3.read_mp3(path)
        except ImportError as e:
            raise RuntimeError(
                f"{path}: MP3 decoding requires the native extension "
                f"(voice100_tpu_torch.native): {e}"
            ) from e
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
