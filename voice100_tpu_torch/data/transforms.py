"""Per-clip log-mel features with an on-disk cache.

Port of the mel path of ``voice100_tpu/data/transforms.py:46-70,106-322``
(the reference's EncodedCacheDataset flow, voice100/data_modules.py:162-241):
features are computed once per clip and cached under
``sha1(salt + clipid)``. The cache keeps the JAX package's file names and
format, so a cache that either package wrote serves both: a log-mel
feature is a raw ``.npy`` (read back memory-mapped; the JAX package keeps
``.npz`` for the WORLD tuples only), published atomically, and quantised
to the cache dtype before it is returned, so a cold read sees what every
warm read will.

The log-mel runs on the port's device (``cuda`` by default) through
:func:`voice100_tpu_torch.ops.melspec_cuda.log_mel_spectrogram_cuda`, one
clip a call, with the JAX package's framing: the waveform is padded with
zeros to a multiple of :data:`WAVE_BUCKET` samples, transformed, and cut
to ``len // 160 + 1`` frames. Without the zero padding the last frames'
reflect padding would see other samples and the features would differ.

The WORLD transforms (``world``, ``world_mcep``) and the mcep round trip
wait for the TTS slice; the native batch decode (``prefetch``) waits for
the data shell.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.audioio import load_audio
from ..ops.melspec import MELSPEC_DIM
from ..ops.melspec_cuda import log_mel_spectrogram_cuda

logger = logging.getLogger(__name__)

__all__ = ["MelSpectrogramAudioTransform", "EncodedCacheDataset", "get_audio_transform",
           "WAVE_BUCKET"]

WAVE_BUCKET = 4096  # waveforms are zero-padded to multiples of this many samples


class MelSpectrogramAudioTransform:
    """audio file -> ``[T, n_mels]`` float32 log-mel, computed on
    ``device`` (default ``cuda``; reference voice100/data_modules.py:262-292)."""

    def __init__(self, sample_rate: int = 16000, n_mels: int = MELSPEC_DIM, device=None) -> None:
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.device = resolve_device(device)

    @property
    def audio_size(self) -> int:
        return self.n_mels

    def __call__(self, audiopath: str) -> np.ndarray:
        wav = load_audio(audiopath, self.sample_rate)
        frames = wav.shape[0] // 160 + 1
        padded = np.zeros(-(-wav.shape[0] // WAVE_BUCKET) * WAVE_BUCKET, np.float32)
        padded[:wav.shape[0]] = wav
        with torch.inference_mode():
            mel = log_mel_spectrogram_cuda(torch.from_numpy(padded).to(self.device),
                                           sample_rate=self.sample_rate, n_mels=self.n_mels)
            return mel[:frames].cpu().numpy()


def get_audio_transform(vocoder: str, sample_rate: int, device=None):
    """Factory (reference voice100/data_modules.py:415-424); mel only."""
    if vocoder == "mel":
        return MelSpectrogramAudioTransform(sample_rate=sample_rate, device=device)
    if vocoder in ("world", "world_mcep"):
        raise NotImplementedError(f"vocoder {vocoder!r}: the WORLD transforms wait for the TTS "
                                  f"slice of the port")
    raise ValueError(f"Unknown vocoder {vocoder!r}")


class EncodedCacheDataset:
    """Applies the audio and text transforms with a feature cache
    (reference voice100/data_modules.py:162-241); items are ``(audio,
    text)``."""

    def __init__(self, dataset, audio_transform, text_transform, cachedir: Optional[str] = None,
                 salt: bytes = b"", cache_dtype: Optional[str] = None) -> None:
        self._dataset = dataset
        self.audio_transform = audio_transform
        self.text_transform = text_transform
        self._cachedir = cachedir
        self._salt = salt
        self._cache_dtype = np.dtype(cache_dtype) if cache_dtype is not None else None

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, index: int):
        clipid, audio, text = self._dataset[index]
        return self._get_encoded_audio(clipid, audio), self.text_transform(text)

    def _cachefile(self, clipid: str) -> Optional[str]:
        if self._cachedir is None:
            return None
        h = hashlib.sha1(self._salt)
        h.update(clipid.encode("utf-8"))
        # the JAX package's name (it swaps the .npz suffix for .npy too)
        return os.path.join(self._cachedir, h.hexdigest() + ".npy")

    def audio_frames(self, index: int) -> Optional[int]:
        """Frame count of the item's cached feature from the ``.npy``
        header alone; ``None`` when the item is not cached yet. Feeds the
        loader's length buckets."""
        cachefile = self._cachefile(self._dataset[index][0])
        if cachefile is None or not os.path.exists(cachefile):
            return None
        try:
            with open(cachefile, "rb") as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    return int(np.lib.format.read_array_header_1_0(f)[0][0])
                return int(np.lib.format.read_array_header_2_0(f)[0][0])
        except Exception:
            return None

    def _get_encoded_audio(self, clipid: str, audiopath: str) -> np.ndarray:
        npyfile = self._cachefile(clipid)
        if npyfile and os.path.exists(npyfile):
            try:
                return np.load(npyfile, mmap_mode="r")
            except Exception:
                logger.warning("Failed to load audio cache", exc_info=True)
        encoded = np.ascontiguousarray(self.audio_transform(audiopath))
        if self._cache_dtype is not None and encoded.dtype == np.float32:
            encoded = encoded.astype(self._cache_dtype)
        if npyfile:
            try:
                # atomic publish: a crash mid-write never leaves a truncated
                # entry (np.save appends the suffix when it is missing)
                tmpfile = f"{npyfile}.{os.getpid()}.tmp.npy"
                np.save(tmpfile, encoded)
                os.replace(tmpfile, npyfile)
            except Exception:
                logger.warning("Failed to save audio cache", exc_info=True)
        return encoded
