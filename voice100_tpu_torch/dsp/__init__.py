"""Host DSP of the data path: WAV I/O, resampling, audio loading."""

from .audioio import load_audio
from .resample import resample
from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav", "resample", "load_audio"]
