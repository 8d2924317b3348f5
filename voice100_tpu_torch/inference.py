"""Serving pipelines: batched, bucketed ASR (greedy) and TTS inference.

``ASRPipeline`` ports the greedy branch of ``voice100_tpu/inference.py:36-292``:
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

``TTSPipeline`` ports ``voice100_tpu/inference.py:435-670``: texts ->
tokens (host) -> durations (the align model, biLSTM kernel) -> one fetch
of the durations, which sizes the frame bucket and feeds the host cursor
-> aligned ids (expanded on the device) -> WORLD features (the audio
model, biLSTM kernel) -> waveforms (batched WORLD synthesis on the
device; the coded aperiodicity makes a float64 round trip through the
host, as in the JAX package). Meshes are not ported and raise.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .dsp.world import WORLDVocoder
from .dsp.world.synthesis import NoiseSource
from .models import AlignTextToAudio, AudioToAlignText, TextToAlignText
from .ops.mask import BLANK_AUDIO, sequence_mask
from .ops.melspec_cuda import log_mel_spectrogram_cuda
from .text import get_phonemizer, get_tokenizer

__all__ = ["ASRPipeline", "TTSPipeline"]


def _bucket(n: int, sizes: Sequence[int]) -> int:
    """The first size that holds ``n``; the last one past them all."""
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


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


class TTSPipeline:
    """texts -> waveforms with the v2 align and audio models, on ``device``
    (default ``cuda``; ``device="cpu"`` runs the plain PyTorch path).

    Texts bucket to ``text_buckets`` tokens and the aligned texts to
    ``frame_buckets`` ids (the decoder doubles them into WORLD frames); a
    text longer than the largest text bucket is split (:meth:`_split_long`)
    and its pieces synthesized in the same batch and concatenated."""

    def __init__(
        self,
        align_model: TextToAlignText,
        audio_model: AlignTextToAudio,
        language: str = "en",
        use_phone: bool = True,
        sample_rate: int = 16000,
        text_buckets: Sequence[int] = (64, 128, 256),
        frame_buckets: Sequence[int] = (256, 512, 1024, 2048),
        mesh=None,
        device=None,
    ) -> None:
        if mesh is not None:
            from .training.cli import DISTRIBUTED_ITEM

            raise NotImplementedError(f"data-parallel serving over a mesh is not ported yet "
                                      f"({DISTRIBUTED_ITEM})")
        self.device = resolve_device(device)
        self.align_model = align_model.to(self.device).eval()
        self.audio_model = audio_model.to(self.device).eval()
        self.phonemizer = get_phonemizer(language, use_phone)
        self.tokenizer = get_tokenizer(language, use_phone)
        self.sample_rate = sample_rate
        self.text_buckets = list(text_buckets)
        self.frame_buckets = list(frame_buckets)
        self.vocoder = WORLDVocoder(sample_rate=sample_rate,
                                    use_mcep=audio_model.logspc_size == 25, device=self.device)

    def _encoded_len(self, text: str) -> int:
        return len(self.tokenizer(self.phonemizer(text)))

    def _split_long(self, text: str) -> List[str]:
        """Split a text whose encoding exceeds the largest text bucket into
        pieces that each fit: sentence-ish punctuation first, then words
        (characters for unspaced scripts), bisection last."""
        return self._split_rec(text, max(self.text_buckets), level=0)

    def _split_rec(self, text: str, max_tokens: int, level: int) -> List[str]:
        """level 0: sentence punctuation; 1: words (characters for
        unspaced scripts); 2+: bisection."""
        if self._encoded_len(text) <= max_tokens or len(text) <= 1:
            return [text]
        if level >= 2:
            mid = len(text) // 2
            return (self._split_rec(text[:mid], max_tokens, 2)
                    + self._split_rec(text[mid:], max_tokens, 2))
        if level == 0:
            parts = [p.strip() for p in re.split(r"(?<=[.!?;:,、。！？；，])\s*", text)
                     if p.strip()]
        else:
            parts = text.split(" ") if " " in text else list(text)
        if len(parts) <= 1:
            return self._split_rec(text, max_tokens, level + 1)
        sep = " " if " " in text else ""
        sep_len = 1 if sep else 0
        pieces: List[str] = []
        cur, cur_len = "", 0
        # token length is close to additive over parts: pack greedily on the
        # parts' encodings, then re-check each piece below
        for part in parts:
            part_len = self._encoded_len(part)
            cand_len = (cur_len + sep_len + part_len) if cur else part_len
            if cur and cand_len > max_tokens:
                pieces.append(cur)
                cur, cur_len = part, part_len
            else:
                cur = (cur + sep + part) if cur else part
                cur_len = cand_len
        if cur:
            pieces.append(cur)
        out: List[str] = []
        for p in pieces:
            if self._encoded_len(p) <= max_tokens:
                out.append(p)
            else:
                out.extend(self._split_rec(p, max_tokens, level + 1))
        return out

    def synthesize(self, texts: List[str], output_dtype=np.float32,
                   noise: NoiseSource = None) -> List[np.ndarray]:
        """Waveforms at ``sample_rate``, float32 in [-1, 1], or int16 PCM
        with ``output_dtype=np.int16`` (quantized on the device before the
        fetch). Texts longer than the largest text bucket are synthesized
        piecewise in the same batch and concatenated. ``noise`` feeds the
        aperiodic excitation (:func:`voice100_tpu_torch.dsp.world.
        synthesize_batch`): None draws it on the device from a generator
        seeded 0; a ``torch.Generator`` draws it on the generator's device;
        a tensor ``[texts, max_pulses, n_fft]`` is used as it is."""
        max_tokens = max(self.text_buckets)
        segments: List[str] = []
        seg_encoded: List[Any] = []
        spans: List[Tuple[int, int]] = []
        for t in texts:
            enc = self.tokenizer(self.phonemizer(t))
            if len(enc) <= max_tokens:
                pieces, piece_enc = [t], [enc]
            else:
                pieces = self._split_long(t)
                piece_enc = [None] * len(pieces)
            spans.append((len(segments), len(pieces)))
            segments.extend(pieces)
            seg_encoded.extend(piece_enc)
        wavs = self._synthesize_batch(segments, output_dtype, encoded=seg_encoded, noise=noise)
        return [np.concatenate(wavs[start:start + count]) if count > 1 else wavs[start]
                for start, count in spans]

    @torch.inference_mode()
    def _synthesize_batch(self, texts: List[str], output_dtype=np.float32,
                          encoded: Optional[List[Any]] = None,
                          noise: NoiseSource = None) -> List[np.ndarray]:
        if encoded is None:
            encoded = [None] * len(texts)
        encoded = [e if e is not None else self.tokenizer(self.phonemizer(t))
                   for t, e in zip(texts, encoded)]
        text_bucket = _bucket(max(len(e) for e in encoded), self.text_buckets)
        n = len(texts)
        text = np.zeros((n, text_bucket), np.int32)
        text_len = np.ones(n, np.int32)
        for i, e in enumerate(encoded):
            e = e[:text_bucket]
            text[i, :len(e)] = e
            text_len[i] = max(len(e), 1)
        text_t = torch.from_numpy(text).to(self.device)
        text_len_t = torch.from_numpy(text_len).to(self.device)

        durations = self.align_model.predict(text_t, text_len_t)
        # the one fetch of the durations: it sizes the frame bucket and feeds
        # the cursor (ops/duration.py)
        durations = durations.cpu().numpy()
        mask = np.arange(text_bucket)[None, :] < text_len[:, None]
        totals = (durations * mask[:, :, None]).sum(axis=(1, 2))
        need = int(np.max(totals)) + text_bucket + 16
        out_len = _bucket(need, self.frame_buckets)
        aligntext, aligntext_len = self.align_model.align(text_t, durations, text_len_t, out_len)
        f0, feat, codeap = self.audio_model.predict(aligntext, aligntext_len)
        audio_lens = np.minimum(aligntext_len.cpu().numpy() * 2, f0.shape[1])
        batch_wav = self.vocoder.decode_batch(f0, feat, codeap, audio_lens, dtype=output_dtype,
                                              noise=noise)
        hop = self.sample_rate * self.vocoder.frame_period / 1000.0
        wavs = []
        for i in range(len(texts)):
            # round the total, not each frame: hop is fractional at 22.05 kHz
            n_samples = int(round(max(int(audio_lens[i]) - 1, 1) * hop)) + 1
            wav = batch_wav[i, :n_samples]
            if batch_wav.dtype == np.int16:
                wavs.append(np.array(wav, dtype=np.int16))
            else:
                wavs.append(np.clip(wav, -1.0, 1.0).astype(np.float32))
        return wavs
