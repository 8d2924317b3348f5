"""Serving pipeline: batched, bucketed ASR inference (greedy decoding).

Port of the greedy branch of ``voice100_tpu/inference.py:36-292``:
waveforms are sorted by length, padded to a small set of bucket lengths
in fixed-size batches, uploaded (int16 PCM as it is, normalised on the
device by the exact power of two 1/32768), turned into log-mel features
by the fused CUDA kernel, masked past each clip's frames to the blank
level, run through the model and reduced to frame-wise argmax ids on the
device. The host decodes ids with the tokenizer and merges repeats.

Every batch is dispatched before any result is fetched, so the host's
token decoding of one batch does not hold up the device's next.

Not ported yet: beam search and LM fusion, meshes, the mel-kernel switch
(the port always takes the kernel on CUDA) and ``StreamingASRSession``;
inputs longer than the largest bucket raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import AudioToAlignText
from .ops.mask import BLANK_AUDIO, sequence_mask
from .ops.melspec_cuda import log_mel_spectrogram_cuda
from .text import get_tokenizer

__all__ = ["ASRPipeline"]


class ASRPipeline:
    """waveforms -> transcripts with the v2 ASR model, on ``device``
    (default ``cuda``; ``device="cpu"`` runs the plain PyTorch path)."""

    def __init__(
        self,
        model: AudioToAlignText,
        language: str = "en",
        use_phone: bool = False,
        sample_rate: int = 16000,
        batch_size: int = 8,
        buckets_sec: Sequence[float] = (2.0, 5.0, 10.0, 20.0, 40.0),
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = get_tokenizer(language, use_phone)
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        self.buckets = [int(s * sample_rate) for s in buckets_sec]

    def _features(self, wav: torch.Tensor, wav_len: torch.Tensor):
        if wav.dtype == torch.int16:
            # 1/32768 is a power of two: bit-exact with dividing on the host
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        mel = log_mel_spectrogram_cuda(wav, sample_rate=self.sample_rate)
        mel_len = wav_len // 160 + 1
        # padded waveform tails give frames past mel_len; set them to the
        # blank level the model was trained with
        mask = sequence_mask(mel_len, mel.shape[1], torch.bool)[:, :, None]
        return torch.where(mask, mel, BLANK_AUDIO), mel_len

    @torch.inference_mode()
    def logits(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """Padded batch ``[B, T]`` + lengths -> ``([B, T', V], [B])``."""
        return self.model(*self._features(wav, wav_len))

    @torch.inference_mode()
    def _decode(self, wav: torch.Tensor, wav_len: torch.Tensor):
        return self.model.greedy_decode(*self._features(wav, wav_len))

    def batches(self, waveforms: List[np.ndarray]) -> Iterator[Tuple[List[int], torch.Tensor, torch.Tensor]]:
        """``(indices, wav [batch_size, bucket], lengths [batch_size])`` on
        the device, shortest clips first. A batch is all int16 when every
        input is int16 PCM, else float32 (int16 entries scaled on host)."""
        for i, w in enumerate(waveforms):
            if len(w) > self.buckets[-1]:
                raise NotImplementedError(
                    f"waveform {i} has {len(w)} samples, more than the largest "
                    f"bucket ({self.buckets[-1]}); long-form streaming is not ported"
                )
        order = list(np.argsort([len(w) for w in waveforms]))
        pcm16 = all(np.asarray(w).dtype == np.int16 for w in waveforms)
        for start in range(0, len(order), self.batch_size):
            chunk = [int(i) for i in order[start:start + self.batch_size]]
            longest = max(len(waveforms[i]) for i in chunk)
            max_len = next(s for s in self.buckets if longest <= s)
            batch = np.zeros((self.batch_size, max_len), np.int16 if pcm16 else np.float32)
            lengths = np.zeros(self.batch_size, np.int32)
            for row, i in enumerate(chunk):
                w = np.asarray(waveforms[i])
                if w.dtype == np.int16 and not pcm16:
                    w = w.astype(np.float32) * (1.0 / 32768.0)
                batch[row, :len(w)] = w
                lengths[row] = len(w)
            yield (chunk, torch.from_numpy(batch).to(self.device),
                   torch.from_numpy(lengths).to(self.device))

    def transcribe(self, waveforms: List[np.ndarray]) -> List[str]:
        """Batch transcription of mono clips at ``sample_rate``, float32
        in [-1, 1] or int16 PCM."""
        pending = [(chunk, *self._decode(wav, lengths))
                   for chunk, wav, lengths in self.batches(waveforms)]
        results = [""] * len(waveforms)
        for chunk, ids, out_len in pending:
            ids, out_len = ids.cpu().numpy(), out_len.cpu().numpy()
            for row, i in enumerate(chunk):
                raw = self.tokenizer.decode(ids[row, :out_len[row]])
                results[i] = self.tokenizer.merge_repeated(raw)
        return results
