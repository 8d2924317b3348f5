"""DSP: the data path's WAV I/O, resampling and audio loading; WORLD
decoding for TTS serving in ``dsp.world`` (with ``dsp.mcep``)."""

from .audioio import load_audio
from .resample import resample
from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav", "resample", "load_audio"]
