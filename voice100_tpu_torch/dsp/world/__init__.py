"""WORLD vocoder: analysis (host NumPy float64, or the device) and decoding.

Port of ``voice100_tpu/dsp/world/__init__.py`` ``WORLDVocoder`` (the
reference's voice100/vocoder.py:14-102): the same rates (16 kHz: n_fft
512, mcep 24, alpha 0.410, codeap 1; 22.05 kHz: 1024/34/0.455/2) and
``output_dims``. ``encode`` runs the host analysis the JAX package runs
by default, copied without JAX (:mod:`.dio`, :mod:`.cheaptrick`,
:mod:`.aperiodicity`), so the features are the JAX package's bit for
bit; with ``analysis_backend="device"`` (alias ``"jax"``, :mod:`.backend`)
it runs the JAX package's device analysis in torch float32 on the
vocoder's device (:mod:`.dio_device` YIN F0, ``_cheaptrick_device``,
``_harmonic_device``) and fetches once at the end. Decoding maps
mel-cepstra to log spectra by one matmul (float32 on the device),
decodes the coded aperiodicity on the host in float64 as the JAX package
does, and synthesizes on the device (:mod:`.synthesis`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..mcep import create_mc2sp_matrix, create_sp2mc_matrix
from .aperiodicity import _harmonic_device, band_aperiodicity, d4c
from .backend import DEVICE, analysis_backend as analysis_backend_of
from .cheaptrick import _cheaptrick_device, cheaptrick
from .codec import code_aperiodicity, decode_aperiodicity, get_num_aperiodicities
from .dio import dio
from .dio_device import dio_device, dio_device_tensors
from .synthesis import NoiseSource, synthesis_shape, synthesize_batch

__all__ = ["WORLDVocoder", "FEATURE_VERSION", "dio", "dio_device", "cheaptrick", "d4c",
           "band_aperiodicity", "code_aperiodicity", "decode_aperiodicity",
           "get_num_aperiodicities",
           "synthesis_shape", "synthesize_batch"]

# the analysis algorithms' version, keyed into the feature cache's salt
# (data/datamodule.py): the JAX package's token, so both read one cache.
# The salt does not name the analysis backend, in either package: a cache
# one backend wrote is read by the other.
FEATURE_VERSION = "ap-harmonic1"


class WORLDVocoder:
    """Encode waveforms to WORLD features ``(f0, logspc or mcep, codeap)``
    and decode them to waveforms on ``device`` (default ``cuda``;
    ``"cpu"`` runs on the CPU). ``analysis_backend`` (default
    ``$VOICE100_TPU_WORLD_BACKEND`` or ``"numpy"``): ``"numpy"`` analyses
    on the host in float64, ``"device"`` (or ``"jax"``) in float32 on
    ``device``; another name raises ``ValueError``."""

    def __init__(self, sample_rate: int = 16000, frame_period: float = 10.0, n_fft: int = None,
                 use_mcep: bool = False, log_offset: float = 1e-15, device=None,
                 analysis_backend: str = None) -> None:
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.frame_period = frame_period
        self.analysis_backend = analysis_backend or os.environ.get(
            "VOICE100_TPU_WORLD_BACKEND", "numpy")
        self._device_analysis = analysis_backend_of(self.analysis_backend) == DEVICE
        if sample_rate == 16000:
            self.mcep_dim, self.mcep_alpha, self.codeap_dim = 24, 0.410, 1
            self.n_fft = n_fft or 512
        elif sample_rate == 22050:
            self.mcep_dim, self.mcep_alpha, self.codeap_dim = 34, 0.455, 2
            self.n_fft = n_fft or 1024
        else:
            raise ValueError("Unsupported sample rate")
        self.use_mcep = use_mcep
        self.log_offset = log_offset
        self.mc2sp_matrix = (create_mc2sp_matrix(self.n_fft, self.mcep_dim, self.mcep_alpha)
                             if use_mcep else None)
        self.sp2mc_matrix = (create_sp2mc_matrix(self.n_fft, self.mcep_dim, self.mcep_alpha)
                             if use_mcep else None)
        self._mc2sp32 = None  # the float32 mc2sp matrix on the device, made at first use
        self._sp2mc64 = None  # the float64 sp2mc matrix of the device analysis, likewise

    def __getstate__(self):
        # a pickled vocoder (the loader's spawned workers) carries no device
        # tensor: unpickling one would open a CUDA context in the worker
        return {**self.__dict__, "_mc2sp32": None, "_sp2mc64": None}

    def to_host(self) -> None:
        """Decode, and analyse on the device backend, on the CPU from now
        on (the loader's workers call it)."""
        self.device = torch.device("cpu")
        self._mc2sp32 = self._sp2mc64 = None

    @property
    def output_dims(self) -> Tuple[int, int, int]:
        if self.use_mcep:
            return 1, self.mcep_dim + 1, self.codeap_dim
        return 1, self.n_fft // 2 + 1, self.codeap_dim

    def encode(self, waveform, f0_floor: float = 80.0, f0_ceil: float = 400.0):
        """waveform -> ``(f0 [T], logspc or mcep [T, D], codeap [T, C])``,
        float32 host arrays: F0, the CheapTrick envelope, its log (and
        mel-cepstrum), the harmonic band aperiodicity. On the host backend
        DIO and the rest in float64; on the device backend YIN F0 and the
        rest in float32 on ``self.device``, one clip a call."""
        if self._device_analysis:
            return self._encode_device(waveform, f0_floor, f0_ceil)
        x = np.asarray(waveform, dtype=np.float64)
        f0, positions = dio(x, self.sample_rate, f0_floor=f0_floor, f0_ceil=f0_ceil,
                            frame_period=self.frame_period)
        spc = cheaptrick(x, f0, positions, self.sample_rate, self.n_fft)
        logspc = np.log(spc + self.log_offset)
        codeap = band_aperiodicity(x, f0, positions, self.sample_rate)
        feat = logspc @ self.sp2mc_matrix if self.use_mcep else logspc
        return f0.astype(np.float32), feat.astype(np.float32), codeap.astype(np.float32)

    def _encode_device(self, waveform, f0_floor: float, f0_ceil: float):
        """The device analysis (``voice100_tpu/dsp/world/__init__.py:104-140``
        with ``analysis_backend="jax"``): the waveform uploaded as float32,
        every estimator on the device, one fetch of the three streams. The
        log envelope is float32 and the sp2mc product float64, as the JAX
        package computes them on its host."""
        dev = self.device
        x = torch.from_numpy(np.array(waveform, np.float32)).to(dev)
        fs = self.sample_rate
        f0, positions = dio_device_tensors(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                                           frame_period=self.frame_period)
        spc = _cheaptrick_device(x, f0, positions, fs, self.n_fft)
        logspc = torch.log(spc + self.log_offset)
        codeap = _harmonic_device(x, f0, positions, fs)
        if self.use_mcep:
            if self._sp2mc64 is None or self._sp2mc64.device != dev:
                self._sp2mc64 = torch.from_numpy(np.array(self.sp2mc_matrix)).to(dev)
            feat = (logspc.double() @ self._sp2mc64).float()
        else:
            feat = logspc
        f0, feat, codeap = (t.cpu().numpy() for t in (f0, feat, codeap))
        return f0, feat, codeap

    def _aperiodicity(self, codeap: np.ndarray) -> np.ndarray:
        """Coded aperiodicity ``[..., C]`` -> ``[..., n_fft//2+1]`` float64 on
        the host."""
        codeap = np.asarray(codeap, np.float64)
        ap = decode_aperiodicity(codeap.reshape(-1, codeap.shape[-1]), self.sample_rate,
                                 self.n_fft)
        return ap.reshape(codeap.shape[:-1] + (self.n_fft // 2 + 1,))

    def decode(self, f0: np.ndarray, logspc_or_mcep: np.ndarray, codeap: np.ndarray,
               noise: NoiseSource = None) -> np.ndarray:
        """One utterance's ``[T]``, ``[T, D]``, ``[T, C]`` host features ->
        ``[samples]`` float32 host waveform. The spectra are float64 on the
        host, as in the JAX package; the synthesis runs on the device."""
        feat = np.asarray(logspc_or_mcep, np.float64)
        logspc = feat @ self.mc2sp_matrix if self.use_mcep else feat
        spc = np.maximum(np.exp(logspc) - self.log_offset, 0.0)
        ap = self._aperiodicity(codeap)

        def up(x):
            return torch.from_numpy(np.asarray(x, np.float32))[None].to(self.device)

        wav = synthesize_batch(up(f0), up(spc), up(ap), fs=self.sample_rate,
                               frame_period=self.frame_period,
                               noise=noise[None] if isinstance(noise, torch.Tensor) else noise)
        return wav[0].cpu().numpy()

    def decode_batch(self, f0, logspc_or_mcep, codeap, lengths, dtype=np.float32,
                     noise: NoiseSource = None) -> np.ndarray:
        """Batched synthesis on the device: ``[B, T]`` / ``[B, T, D]`` /
        ``[B, T, C]`` padded features (tensors or arrays) and ``lengths
        [B]`` -> ``[B, samples]`` host waveforms. Frames at or past a length
        are muted. ``dtype=np.int16`` clips to [-1, 1] and quantizes to
        16-bit PCM on the device (round half to even) before the fetch.
        ``noise``: see :func:`synthesize_batch`."""
        dev = self.device
        f0 = torch.as_tensor(f0, dtype=torch.float32).to(dev)
        feat = torch.as_tensor(logspc_or_mcep, dtype=torch.float32).to(dev)
        codeap = codeap.cpu().numpy() if isinstance(codeap, torch.Tensor) else codeap
        if self.use_mcep and self._mc2sp32 is None:
            self._mc2sp32 = torch.from_numpy(self.mc2sp_matrix.astype(np.float32)).to(dev)
        logspc = feat @ self._mc2sp32 if self.use_mcep else feat
        spc = torch.clamp(torch.exp(logspc) - self.log_offset, min=0.0)
        ap = torch.from_numpy(self._aperiodicity(codeap).astype(np.float32)).to(dev)
        lengths = torch.as_tensor(np.asarray(lengths)).to(dev)
        frame_ok = torch.arange(f0.shape[1], device=dev)[None, :] < lengths[:, None]
        f0 = torch.where(frame_ok, f0, 0.0)
        spc = torch.where(frame_ok[:, :, None], spc, 1e-12)
        wav = synthesize_batch(f0, spc, ap, fs=self.sample_rate, frame_period=self.frame_period,
                               noise=noise)
        if np.dtype(dtype) == np.int16:
            wav = torch.round(wav.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return wav.cpu().numpy()
