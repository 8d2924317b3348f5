"""Per-clip audio features (log-mel or WORLD) with an on-disk cache.

Port of ``voice100_tpu/data/transforms.py:46-104,106-322`` (the
reference's EncodedCacheDataset flow, voice100/data_modules.py:162-241):
features are computed once per clip and cached under
``sha1(salt + clipid)``. The cache keeps the JAX package's file names and
format, so a cache that either package wrote serves both: a log-mel
feature is a raw ``.npy`` (read back memory-mapped), a WORLD tuple an
``.npz`` of its arrays; each is published atomically, and a log-mel
feature is quantised to the cache dtype before it is returned, so a cold
read sees what every warm read will. WORLD features are supervision
targets: their data module caches them as float32 (no cache dtype). They
are cached as mel-cepstra: for
``vocoder="world"`` the log spectrum is mapped to mcep before the write
and back through ``mc2sp`` on every read, cold or warm, so ``world`` and
``world_mcep`` share one cache.

The log-mel runs on the port's device (``cuda`` by default) through
:func:`voice100_tpu_torch.ops.melspec_cuda.log_mel_spectrogram_cuda`, one
clip a call, with the JAX package's framing: the waveform is padded with
zeros to a multiple of :data:`WAVE_BUCKET` samples, transformed, and cut
to ``len // 160 + 1`` frames. Without the zero padding the last frames'
reflect padding would see other samples and the features would differ.

The WORLD analysis runs on the host in float64
(:meth:`voice100_tpu_torch.dsp.world.WORLDVocoder.encode`), as the JAX
package's default backend does.

:meth:`EncodedCacheDataset.prefetch` decodes the audio of a batch's cache
misses in one call of the native thread pool
(:func:`voice100_tpu_torch.native.batch.load_audio_batch`: first channel,
resampled in C++) and keeps the waves for ``__getitem__``; the loader
calls it before each batch's items. Where the native library cannot be
loaded it logs one warning and the items decode one by one
(:func:`voice100_tpu_torch.dsp.audioio.load_audio`).
"""

from __future__ import annotations

import hashlib
import logging
import os
import zipfile
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.audioio import load_audio
from ..dsp.mcep import create_mc2sp_matrix, create_sp2mc_matrix
from ..ops.melspec import MELSPEC_DIM
from ..ops.melspec_cuda import log_mel_spectrogram_cuda

logger = logging.getLogger(__name__)

__all__ = ["MelSpectrogramAudioTransform", "WORLDAudioProcessor", "EncodedCacheDataset",
           "get_audio_transform", "WAVE_BUCKET"]

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

    def to_host(self) -> None:
        """Compute on the CPU from now on: the plain log-mel (the loader's
        worker processes call it; ``data/loader.py``)."""
        self.device = torch.device("cpu")

    def __call__(self, audiopath: str, wav: Optional[np.ndarray] = None) -> np.ndarray:
        if wav is None:
            wav = load_audio(audiopath, self.sample_rate)
        frames = wav.shape[0] // 160 + 1
        padded = np.zeros(-(-wav.shape[0] // WAVE_BUCKET) * WAVE_BUCKET, np.float32)
        padded[:wav.shape[0]] = wav
        with torch.inference_mode():
            mel = log_mel_spectrogram_cuda(torch.from_numpy(padded).to(self.device),
                                           sample_rate=self.sample_rate, n_mels=self.n_mels)
            return mel[:frames].cpu().numpy()


class WORLDAudioProcessor:
    """audio file -> ``(f0 [T], logspc or mcep [T, D], codeap [T, C])``
    float32 WORLD features (reference voice100/data_modules.py:295-316),
    analysed on the host, or on ``device`` under the device analysis
    backend (``VOICE100_TPU_WORLD_BACKEND=device``). ``device`` (default
    ``cuda``) is the vocoder's."""

    def __init__(self, sample_rate: int, use_mcep: bool, device=None) -> None:
        from ..dsp.world import WORLDVocoder

        self.sample_rate = sample_rate
        self.vocoder = WORLDVocoder(sample_rate=sample_rate, use_mcep=use_mcep, device=device)

    @property
    def audio_size(self) -> int:
        return sum(self.vocoder.output_dims)

    def to_host(self) -> None:
        """The vocoder decodes, and the device analysis backend analyses,
        on the CPU from now on (the loader's worker processes call it)."""
        self.vocoder.to_host()

    def __call__(self, audiopath: str, wav: Optional[np.ndarray] = None):
        if wav is None:
            wav = load_audio(audiopath, self.sample_rate)
        return self.vocoder.encode(np.asarray(wav, np.float64))


def get_audio_transform(vocoder: str, sample_rate: int, device=None):
    """Factory (reference voice100/data_modules.py:415-424)."""
    if vocoder == "mel":
        return MelSpectrogramAudioTransform(sample_rate=sample_rate, device=device)
    if vocoder in ("world", "world_mcep"):
        return WORLDAudioProcessor(sample_rate, use_mcep=vocoder == "world_mcep", device=device)
    raise ValueError(f"Unknown vocoder {vocoder!r}")


class EncodedCacheDataset:
    """Applies the audio and text transforms with a feature cache
    (reference voice100/data_modules.py:162-241); items are ``(audio,
    text)``, ``audio`` one array (log-mel) or a tuple (WORLD), and ``(audio,
    text, targettext)`` with a ``targettext_transform`` (the multi-task
    model's phone targets)."""

    def __init__(self, dataset, audio_transform, text_transform, cachedir: Optional[str] = None,
                 salt: bytes = b"", cache_dtype: Optional[str] = None,
                 targettext_transform=None) -> None:
        self._dataset = dataset
        self.audio_transform = audio_transform
        self.text_transform = text_transform
        self.targettext_transform = targettext_transform
        self._cachedir = cachedir
        self._salt = salt
        self._cache_dtype = np.dtype(cache_dtype) if cache_dtype is not None else None
        # waves that prefetch decoded, by clip id, until __getitem__ takes them
        self._preloaded = {}
        self._native_warned = False
        # the log spectrum is cached as mcep and rebuilt on read
        self.save_mcep = (isinstance(audio_transform, WORLDAudioProcessor)
                          and not audio_transform.vocoder.use_mcep)
        if self.save_mcep:
            vocoder = audio_transform.vocoder
            args = (vocoder.n_fft, vocoder.mcep_dim, vocoder.mcep_alpha)
            self.mc2sp_matrix = create_mc2sp_matrix(*args).astype(np.float32)
            self.sp2mc_matrix = create_sp2mc_matrix(*args).astype(np.float32)

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, index: int):
        if self.targettext_transform is not None:
            clipid, audio, text, targettext = self._dataset[index]
            return (self._get_encoded_audio(clipid, audio), self.text_transform(text),
                    self.targettext_transform(targettext))
        clipid, audio, text = self._dataset[index]
        return self._get_encoded_audio(clipid, audio), self.text_transform(text)

    def prefetch(self, indices) -> None:
        """Decode the audio of the items of ``indices`` that miss the
        feature cache in one call of the native thread pool and keep the
        waves for ``__getitem__`` (``voice100_tpu/data/transforms.py:175-
        210``). A file the pool fails to decode is left to the per-item
        path, which raises with its name. Where the native library cannot
        be loaded this logs one warning and returns."""
        todo = []
        for index in indices:
            clipid, audiopath = self._dataset[int(index)][:2]
            cachefile = self._cachefile(clipid)
            if clipid in self._preloaded or (cachefile and (
                    os.path.exists(cachefile) or os.path.exists(cachefile[:-4] + ".npy"))):
                continue
            todo.append((clipid, audiopath))
        if not todo:
            return
        try:
            from ..native.batch import load_audio_batch

            wavs = load_audio_batch([path for _, path in todo], self.audio_transform.sample_rate)
        except ImportError as err:
            if not self._native_warned:
                self._native_warned = True
                logger.warning("native batch decode unavailable, decoding clip by clip: %s", err)
            return
        for (clipid, _), wav in zip(todo, wavs):
            if wav is not None:
                self._preloaded[clipid] = wav

    def _cachefile(self, clipid: str) -> Optional[str]:
        """The ``.npz`` name of a clip's entry (a single array is stored
        beside it as ``.npy``, as the JAX package stores it)."""
        if self._cachedir is None:
            return None
        h = hashlib.sha1(self._salt)
        h.update(clipid.encode("utf-8"))
        return os.path.join(self._cachedir, h.hexdigest() + ".npz")

    def audio_frames(self, index: int) -> Optional[int]:
        """Frame count of the item's cached feature from a header alone:
        the ``.npy`` file's, or the ``.npz`` file's first entry's (WORLD
        f0); ``None`` when the item is not cached yet. Feeds the loader's
        length buckets."""
        cachefile = self._cachefile(self._dataset[index][0])
        if cachefile is None:
            return None

        def head_rows(f) -> int:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                return int(np.lib.format.read_array_header_1_0(f)[0][0])
            return int(np.lib.format.read_array_header_2_0(f)[0][0])

        try:
            npyfile = cachefile[:-4] + ".npy"
            if os.path.exists(npyfile):
                with open(npyfile, "rb") as f:
                    return head_rows(f)
            if os.path.exists(cachefile):
                with zipfile.ZipFile(cachefile) as z, z.open(z.namelist()[0]) as f:
                    return head_rows(f)
        except Exception:
            return None
        return None

    def _quantize(self, arr: np.ndarray) -> np.ndarray:
        if self._cache_dtype is not None and arr.dtype == np.float32:
            return arr.astype(self._cache_dtype)
        return arr

    def _read(self, cachefile: str):
        npyfile = cachefile[:-4] + ".npy"
        try:
            if os.path.exists(npyfile):
                # memory-mapped: collate copies straight from the page cache
                return np.load(npyfile, mmap_mode="r")
            if os.path.exists(cachefile):
                with np.load(cachefile) as z:
                    encoded = tuple(z[k] for k in z.files)
                return encoded[0] if len(encoded) == 1 else encoded
        except Exception:
            logger.warning("Failed to load audio cache", exc_info=True)
        return None

    def _write(self, cachefile: str, encoded) -> None:
        """Atomic publish: a crash mid-write never leaves a truncated entry
        (np.save and np.savez append the suffix when it is missing, so the
        temporary names keep it)."""
        try:
            if isinstance(encoded, tuple):
                tmpfile = f"{cachefile}.{os.getpid()}.tmp.npz"
                np.savez(tmpfile, *encoded)
                os.replace(tmpfile, cachefile)
            else:
                npyfile = cachefile[:-4] + ".npy"
                tmpfile = f"{npyfile}.{os.getpid()}.tmp.npy"
                np.save(tmpfile, encoded)
                os.replace(tmpfile, npyfile)
        except Exception:
            logger.warning("Failed to save audio cache", exc_info=True)

    def _get_encoded_audio(self, clipid: str, audiopath: str):
        cachefile = self._cachefile(clipid)
        encoded = self._read(cachefile) if cachefile else None
        if encoded is None:
            encoded = self.audio_transform(audiopath, wav=self._preloaded.pop(clipid, None))
            if self.save_mcep:
                f0, logspc, codeap = encoded
                encoded = (f0, logspc @ self.sp2mc_matrix, codeap)
            if isinstance(encoded, tuple):
                encoded = tuple(self._quantize(a) for a in encoded)
            else:
                encoded = self._quantize(np.ascontiguousarray(encoded))
            if cachefile:
                self._write(cachefile, encoded)
        if self.save_mcep:
            f0, mcep, codeap = encoded
            encoded = (f0, mcep @ self.mc2sp_matrix, codeap)
        return encoded
