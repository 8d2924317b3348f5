"""Serving pipelines: batched, bucketed ASR and TTS inference.

``ASRPipeline`` ports ``voice100_tpu/inference.py:36-292``: waveforms are
sorted by length, padded in fixed-size batches, uploaded (int16 PCM as it
is, normalised on the device by the exact power of two 1/32768), turned
into log-mel features by the fused CUDA kernel, masked past each clip's
frames to the blank level and run through the model.

A batch is padded to its longest clip plus the front end's right reach
(``reach``: the samples past a clip's end that its valid logit frames
read, through the log-mel window and the conv encoder), rounded up to
0.1 s (10 mel hops), and never past the bucket its longest clip falls in.
With the reach met every valid logit frame is the one a bucket-wide pad
gives (up to the last bits where the card's libraries pick another
algorithm at another shape), so the transcripts do not change. The JAX
package pads to the buckets themselves because XLA compiles one program
a shape; the port's kernels and library calls compile nothing a shape, so
here the buckets are only the cap on a batch's width and the threshold
past which a clip streams. An encoder with a transposed conv has no such
reach and keeps the bucket widths.

Greedy decoding (the default) reduces the logits to frame-wise argmax ids
on the device; the host decodes them with the tokenizer and merges
repeats. ``beam_size > 0`` decodes by CTC prefix
beam search instead: on the device by default
(``ops/ctc_beam_device.py``, ``beam_topk`` extension symbols a frame; the
host fetches the collapsed ids), or with ``beam_device=False`` on the host
over the fetched log-probs, one clip at a time (``ops/ctc_beam.py``).
``lm`` (a :class:`voice100_tpu_torch.text.ngram.CharNgramLM`, the path of
its ``.npz`` or a raw ``[V, V, V]`` table) adds trigram shallow fusion to
either beam (``lm_weight``, ``lm_bonus``); a table whose vocabulary is not
the tokenizer's raises ``ValueError``.

Every batch is dispatched before any result is fetched, so the host's
token decoding of one batch does not hold up the device's next. On a CUDA
device a batch is padded into pinned host memory (PyTorch's caching host
allocator, so a bucket's block is reused from call to call and the pad
takes no page faults) and its upload is enqueued on the current stream
without a host sync: the host pads the next batch while the card runs
the one before. Every element of the buffer is written, since a reused
block holds an earlier batch. A CPU device pads the same way into
ordinary memory.

``transcribe`` streams a clip longer than the largest bucket through a
:class:`StreamingASRSession` (``voice100_tpu/inference.py:197-219``) with
contexts derived from that bucket, fed in pieces of the smallest bucket;
such a clip decodes greedily, beam or not. :meth:`ASRPipeline.batches`
still raises ``NotImplementedError`` for a clip handed to it directly.
``streamed`` keeps a bounded record of the clips ``transcribe`` streamed.
Under a trace (:mod:`voice100_tpu_torch.utils.profiling`) a call is the
span ``asr.transcribe`` (with the caching allocator's calls across it),
and each batch marks ``asr.pad`` (the bucket check and sort, then its
pad), ``asr.upload``, ``asr.dispatch``, ``asr.fetch`` and ``asr.text``;
the counter ``asr.staged`` takes one a batch uploaded from pinned memory,
and on every device ``asr.padded_samples`` takes a batch's
``batch_size x width`` and ``asr.clip_samples`` its clips' samples.

``StreamingASRSession`` ports ``voice100_tpu/inference.py:295-432``:
block decoding of a live stream, each window at B=1 through the greedy
path, frames older than the right context committed, the left context
kept as warm-up.

The JAX package's ``mel_kernel`` switch (``voice100_tpu/inference.py:55,
128-150``) picks its TPU backend (Pallas or XLA) and has no counterpart
here: the front end is :func:`log_mel_spectrogram_cuda`, kernel 8 on a
CUDA tensor and its plain version on a CPU tensor.

``TTSPipeline`` ports ``voice100_tpu/inference.py:435-670``: texts ->
tokens (host) -> durations (the align model, biLSTM kernel) -> one fetch
of the durations, which sizes the frame bucket and feeds the host cursor
-> aligned ids (expanded on the device) -> WORLD features (the audio
model, biLSTM kernel) -> waveforms (batched WORLD synthesis on the
device; the coded aperiodicity makes a float64 round trip through the
host, as in the JAX package).

Both pipelines take ``mesh``, a :class:`voice100_tpu_torch.parallel.Mesh`
(data-parallel serving, ``voice100_tpu/inference.py:114-126, 614-626``):
the models are copied onto each device of its ``data`` axis, and each
batch's rows are cut into contiguous shards, one a device, run there (the
kernels of each model on each shard) and put back in order on the first
device, which runs the rest. ``ASRPipeline`` needs ``batch_size`` to
divide by the data axis (the JAX package's ``ValueError``);
``TTSPipeline`` pads a batch's rows up to a multiple of it (wrap-around
repeats, cut off after the models). A mesh of one device is the plain
call on that device. A ``(d, m)`` mesh with a ``model`` axis serves as its
``data`` axis does (the JAX pipelines replicate their variables,
``voice100_tpu/inference.py:114-126, 455-464``): the model-axis devices
add no work and change no output. Long-form streaming windows (B=1) run
on the first device.
"""

from __future__ import annotations

import re
from collections import deque
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .dsp.world import WORLDVocoder
from .dsp.world.synthesis import NoiseSource
from .models import AlignTextToAudio, AudioToAlignText, TextToAlignText
from .models.layers import conv_stack_output_length
from .ops.ctc_beam import ctc_prefix_beam_search
from .ops.ctc_beam_device import ctc_prefix_beam_search_batched
from .ops.mask import BLANK_AUDIO, sequence_mask
from .ops.melspec_cuda import log_mel_spectrogram_cuda
from .parallel.mesh import Mesh, pad_batch_to_multiple, replicate, shard_batch
from .text import get_phonemizer, get_tokenizer
from .text.ngram import CharNgramLM
from .utils.profiling import count, span

__all__ = ["ASRPipeline", "StreamingASRSession", "TTSPipeline"]


def _bucket(n: int, sizes: Sequence[int]) -> int:
    """The first size that holds ``n``; the last one past them all."""
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


# the front end of ``ASRPipeline._features``: the log-mel hop, and the FFT
# size whose frame reads n_fft // 2 samples past its centre
_HOP = 160
_N_FFT = 512
# a batch's width rounds up to 10 mel hops (0.1 s at 16 kHz)
_WIDTH_STEP = 10 * _HOP


def _front_end_reach(settings) -> Optional[int]:
    """The least number of samples past a clip's end that its batch must
    hold for every logit frame below the clip's output length to read
    only samples and mel frames that exist in the tensor, for a conv
    encoder of ``settings`` behind the log-mel front end. The mel frames
    below ``mel_len`` read ``n_fft // 2`` samples past their centres
    (closer to the edge the reflect padding would replace those zeros);
    the encoder's valid outputs read masked mel frames past ``mel_len`` up
    to its right reach (missing frames would be the conv's zero padding,
    not the blank level). None for an encoder with a transposed conv."""
    if any(transpose for _, transpose, *_ in settings):
        return None
    period = _HOP  # what a clip's end needs, less its length, repeats
    for _, _, _, stride, _, _ in settings:
        period *= stride
    reach = 0
    for n in range(period):
        mel_len = n // _HOP + 1
        frame = conv_stack_output_length(settings, mel_len) - 1  # its last valid output
        for _, _, kernel, stride, padding, _ in reversed(settings):
            frame = frame * stride - padding + kernel - 1  # the last input that one reads
        need = max(_HOP * frame, (mel_len - 1) * _HOP + _N_FFT // 2)
        reach = max(reach, need - n)
    return reach


def _serving_devices(mesh, device) -> List[torch.device]:
    """The devices a pipeline runs on: ``mesh``'s data axis, else ``device``."""
    if mesh is None:
        return [resolve_device(device)]
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a voice100_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    return [resolve_device(d) for d in mesh.data_devices]


def _over_mesh(mesh, fn, *rows):
    """``fn(i, *shard)`` for each device ``i`` of ``mesh``'s data axis on
    its contiguous shard of ``rows`` (tensors with a leading batch axis,
    padded by wrap-around repeats to a multiple of the axis); the outputs'
    rows (a tensor or a tuple of them) come back in order on the first
    device, cut to the rows given. Without a mesh, or with one device,
    ``fn(0, *rows)``."""
    if mesh is None or mesh.shape["data"] == 1:
        return fn(0, *rows)
    padded, n = pad_batch_to_multiple(rows, mesh.shape["data"])
    outs = [fn(i, *shard) for i, shard in enumerate(shard_batch(padded, mesh))]
    first = mesh.data_devices[0]

    def cat(parts):
        return torch.cat([part.to(first) for part in parts])[:n]

    if isinstance(outs[0], tuple):
        return tuple(cat(parts) for parts in zip(*outs))
    return cat(outs)


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
        beam_size: int = 0,
        beam_device: bool = True,
        beam_topk: int = 8,
        lm=None,
        lm_weight: float = 0.5,
        lm_bonus: float = 0.0,
        mesh=None,
    ) -> None:
        devices = _serving_devices(mesh, device)
        if mesh is not None and batch_size % mesh.shape["data"] != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by the mesh data axis "
                             f"{mesh.shape['data']}")
        self.mesh = mesh
        self.device = devices[0]
        # one copy of the model a device of the mesh (the model itself on the first)
        self._models = ([model.to(self.device)] if mesh is None else replicate(model, mesh))
        for m in self._models:
            m.eval()
        self.model = self._models[0]
        self.tokenizer = get_tokenizer(language, use_phone)
        self.beam_size = beam_size
        self.beam_device = beam_device
        self.beam_topk = beam_topk
        self.lm_weight = float(lm_weight)
        self.lm_bonus = float(lm_bonus)
        self.lm_table = None
        if lm is not None:
            if isinstance(lm, str):
                lm = CharNgramLM.load(lm)
            self.lm_table = np.asarray(getattr(lm, "table", lm), np.float32)
            if self.lm_table.shape[2] != self.tokenizer.vocab_size:
                # a table of another vocabulary would gather wrong rows
                raise ValueError(
                    f"LM vocab {self.lm_table.shape[2]} != tokenizer vocab "
                    f"{self.tokenizer.vocab_size} (language={language!r}, "
                    f"use_phone={use_phone}) — train the LM on the same prepared corpus "
                    "(tools/train_lm.py)")
        # the LM table on each device of the mesh
        self._lm_tables = [None if self.lm_table is None
                           else torch.from_numpy(self.lm_table).to(d) for d in devices]
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        self.buckets = [int(s * sample_rate) for s in buckets_sec]
        # samples past its longest clip a batch is padded to (None: to the bucket)
        self.reach = _front_end_reach(self.model.encoder_settings)
        # one record a clip transcribe streamed: samples, frames committed
        # and windows decoded (bounded, as a long-running server keeps it)
        self.streamed = deque(maxlen=1024)

    def _features(self, wav: torch.Tensor, wav_len: torch.Tensor):
        if wav.dtype == torch.int16:
            # 1/32768 is a power of two: bit-exact with dividing on the host
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        mel = log_mel_spectrogram_cuda(wav, sample_rate=self.sample_rate)
        mel_len = wav_len // _HOP + 1
        # padded waveform tails give frames past mel_len; set them to the
        # blank level the model was trained with
        mask = sequence_mask(mel_len, mel.shape[1], torch.bool)[:, :, None]
        return torch.where(mask, mel, BLANK_AUDIO), mel_len

    @torch.inference_mode()
    def logits(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """Padded batch ``[B, T]`` + lengths -> ``([B, T', V], [B])``."""
        return self.model(*self._features(wav, wav_len))

    @torch.inference_mode()
    def log_probs(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """Padded batch ``[B, T]`` + lengths -> ``(log-softmax [B, T', V], [B])``."""
        logits, out_len = self.model(*self._features(wav, wav_len))
        return torch.log_softmax(logits, dim=-1), out_len

    @torch.inference_mode()
    def _greedy(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """Frame-wise argmax ids ``[B, T']`` and their lengths, whatever
        ``beam_size`` is (the streaming windows decode so)."""
        return self.model.greedy_decode(*self._features(wav, wav_len))

    @torch.inference_mode()
    def _decode(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """The batch's device result: greedy ids, the device beam's
        collapsed ids, or (host beam) the log-probs; each with its lengths.
        Over a mesh each device decodes its shard of the rows."""
        return _over_mesh(self.mesh, self._decode_rows, wav, wav_len)

    def _decode_rows(self, i: int, wav: torch.Tensor, wav_len: torch.Tensor):
        """:meth:`_decode` of rows on the mesh's ``i``-th device (the
        pipeline's device without a mesh), with that device's model."""
        model = self._models[i]
        features = self._features(wav, wav_len)
        if self.beam_size <= 0:
            return model.greedy_decode(*features)
        logits, out_len = model(*features)
        log_probs = torch.log_softmax(logits, dim=-1)
        if not self.beam_device:
            return log_probs, out_len
        return ctc_prefix_beam_search_batched(
            log_probs, out_len, beam_size=self.beam_size, topk=self.beam_topk,
            lm_table=self._lm_tables[i], lm_weight=self.lm_weight, lm_bonus=self.lm_bonus)

    def _text(self, out: np.ndarray, n: int) -> str:
        """One row's transcript from its fetched device result."""
        if self.beam_size <= 0:
            return self.tokenizer.merge_repeated(self.tokenizer.decode(out[:n]))
        if self.beam_device:  # the beam's ids are collapsed already
            return self.tokenizer.decode(list(out[:n]))
        return self.tokenizer.decode(ctc_prefix_beam_search(
            out[:n], beam_size=self.beam_size, lm_table=self.lm_table,
            lm_weight=self.lm_weight, lm_bonus=self.lm_bonus))

    def batches(self, waveforms: List[np.ndarray]) -> Iterator[Tuple[List[int], torch.Tensor, torch.Tensor]]:
        """``(indices, wav [batch_size, width], lengths [batch_size])`` on
        the device, shortest clips first. ``width`` is the batch's longest
        clip plus ``reach``, rounded up to 10 mel hops, or the bucket that
        clip falls in where that is narrower (or where the encoder has no
        reach): the buckets are the JAX package's shapes, kept here only as
        the cap. A batch is all int16 when every input is int16 PCM, else
        float32 (int16 entries scaled on host). On CUDA each batch is
        staged in pinned memory and uploaded without a host sync."""
        staged = self.device.type == "cuda"
        order = None
        for start in range(0, len(waveforms), self.batch_size):
            with span("asr.pad"):
                if order is None:  # the first batch's pad takes the check and the sort
                    self._check_buckets(waveforms)
                    order = list(np.argsort([len(w) for w in waveforms]))
                    pcm16 = all(np.asarray(w).dtype == np.int16 for w in waveforms)
                chunk = [int(i) for i in order[start:start + self.batch_size]]
                longest = max(len(waveforms[i]) for i in chunk)
                max_len = next(s for s in self.buckets if longest <= s)
                if self.reach is not None:
                    max_len = min(max_len, -(-(longest + self.reach) // _WIDTH_STEP) * _WIDTH_STEP)
                # a pinned block may come back holding an earlier batch:
                # every element is written, none is assumed zero
                batch = torch.empty((self.batch_size, max_len),
                                    dtype=torch.int16 if pcm16 else torch.float32,
                                    pin_memory=staged)
                lengths = torch.empty(self.batch_size, dtype=torch.int32, pin_memory=staged)
                rows, n = batch.numpy(), lengths.numpy()
                for row, i in enumerate(chunk):
                    w = np.asarray(waveforms[i])
                    if w.dtype == np.int16 and not pcm16:
                        w = w.astype(np.float32) * (1.0 / 32768.0)
                    rows[row, :len(w)] = w
                    rows[row, len(w):] = 0
                    n[row] = len(w)
                rows[len(chunk):] = 0
                n[len(chunk):] = 0
            with span("asr.upload"):
                wav = batch.to(self.device, non_blocking=staged)
                wav_len = lengths.to(self.device, non_blocking=staged)
            if staged:
                count("asr.staged")
            count("asr.padded_samples", self.batch_size * max_len)
            count("asr.clip_samples", int(n.sum()))
            yield chunk, wav, wav_len

    def _check_buckets(self, waveforms) -> None:
        for i, w in enumerate(waveforms):
            if len(w) > self.buckets[-1]:
                raise NotImplementedError(
                    f"waveform {i} has {len(w)} samples, more than the largest "
                    f"bucket ({self.buckets[-1]}); transcribe streams such clips"
                )

    def transcribe(self, waveforms: List[np.ndarray]) -> List[str]:
        """Batch transcription of mono clips at ``sample_rate``, float32
        in [-1, 1] or int16 PCM. A clip longer than the largest bucket
        streams through a :class:`StreamingASRSession` first; the others
        are dispatched in batches, and fetched after the last dispatch."""
        with span("asr.transcribe", device=self.device):
            results = [""] * len(waveforms)
            short = []
            for i, wav in enumerate(waveforms):
                if len(wav) > self.buckets[-1]:
                    results[i] = self._stream(wav)
                else:
                    short.append(i)
            clips = [waveforms[i] for i in short]
            pending = []
            for chunk, wav, lengths in self.batches(clips):
                with span("asr.dispatch"):
                    pending.append((chunk, *self._decode(wav, lengths)))
            for chunk, out, out_len in pending:
                with span("asr.fetch"):
                    out, out_len = out.cpu().numpy(), out_len.cpu().numpy()
                with span("asr.text"):
                    for row, i in enumerate(chunk):
                        results[short[i]] = self._text(out[row], int(out_len[row]))
            return results

    def _stream(self, wav: np.ndarray) -> str:
        """A long clip's transcript through a session whose contexts come
        from the largest bucket, so the decode window always covers the
        committed frontier (at most left + right + 2 chunks = 7/8 of the
        bucket): no interior audio is lost to the window bound."""
        bucket_sec = self.buckets[-1] / self.sample_rate
        session = StreamingASRSession(self, chunk_sec=bucket_sec / 4,
                                      right_context_sec=bucket_sec / 8,
                                      left_context_sec=bucket_sec / 4)
        step = self.buckets[0]
        for start in range(0, len(wav), step):
            session.feed(wav[start:start + step])
        text = session.finish()
        self.streamed.append({"samples": len(wav), "committed_frame": session._committed_frame,
                              "windows": session.windows})
        return text


class StreamingASRSession:
    """Incremental transcription of a live audio stream with the
    bidirectional v2 CTC model (``voice100_tpu/inference.py:295-432``).

    Audio arrives in chunks of any size through :meth:`feed`. Every
    ``chunk_sec`` of new audio the window is decoded greedily at B=1 on
    the pipeline's device, and the logit frames older than
    ``right_context_sec`` are committed: the backward direction has seen
    that much future audio for them. ``left_context_sec`` of committed
    audio stays in the window as warm-up; older samples are dropped
    (``None`` keeps them all), which bounds memory and work for an
    unbounded stream. A window longer than the largest bucket slides to
    its tail, frame-aligned. CTC collapse runs over the committed ids, so
    tokens merge across window boundaries, and the transcript grows as a
    chain of prefixes. Committed ids are never decoded again.

    ``windows`` counts the windows decoded."""

    def __init__(self, pipeline: ASRPipeline, chunk_sec: float = 0.5,
                 right_context_sec: float = 0.64,
                 left_context_sec: Optional[float] = 2.0) -> None:
        self.pipeline = pipeline
        rate = pipeline.sample_rate
        # samples a logit frame: the 160-sample mel hop times the encoder's
        # total time downsampling (the product of its strides)
        downsample = 1
        for _, transpose, _, stride, _, _ in pipeline.model.encoder_settings:
            if transpose:
                raise ValueError("streaming requires a downsampling (non-transpose) encoder")
            downsample *= stride
        self._SAMPLES_PER_FRAME = 160 * downsample
        self.chunk = int(chunk_sec * rate)
        self.right_context = int(right_context_sec * rate)
        self.left_context = None if left_context_sec is None else int(left_context_sec * rate)
        self._buffer = np.zeros(0, np.float32)
        self._base = 0  # absolute sample index of _buffer[0]
        self._committed_frame = 0  # absolute logit frames committed
        self._committed_ids: List[int] = []
        self._since_decode = 0
        self.windows = 0

    @property
    def transcript(self) -> str:
        tok = self.pipeline.tokenizer
        return tok.merge_repeated(tok.decode(self._committed_ids))

    def _decode_window(self) -> Tuple[np.ndarray, int]:
        """The window's greedy ids and the absolute frame of its start."""
        spf = self._SAMPLES_PER_FRAME
        pipe = self.pipeline
        # past the largest bucket the window slides to the buffer's tail,
        # frame-aligned: the frames that fall off are committed already, or
        # lost to the window bound (contexts too wide for the bucket)
        offset = 0
        if len(self._buffer) > pipe.buckets[-1]:
            offset = -(-(len(self._buffer) - pipe.buckets[-1]) // spf) * spf
        window = self._buffer[offset:]
        max_len = _bucket(len(window), pipe.buckets)
        wav = np.zeros((1, max_len), np.float32)
        valid = min(len(window), max_len)
        wav[0, :valid] = window[:valid]
        ids, out_len = pipe._greedy(torch.from_numpy(wav).to(pipe.device),
                                    torch.tensor([valid], dtype=torch.int32, device=pipe.device))
        self.windows += 1
        ids, out_len = ids.cpu().numpy(), out_len.cpu().numpy()
        return ids[0, :int(out_len[0])], (self._base + offset) // spf

    def _commit_until(self, end_frame_abs: int) -> None:
        if end_frame_abs <= self._committed_frame:
            return
        ids, window_start_frame = self._decode_window()
        # frames before the window's start were lost to the window bound
        rel_start = max(self._committed_frame - window_start_frame, 0)
        self._committed_frame = max(self._committed_frame, window_start_frame)
        rel_end = min(end_frame_abs - window_start_frame, len(ids))
        if rel_end <= rel_start:
            return
        self._committed_ids.extend(int(i) for i in ids[rel_start:rel_end])
        self._committed_frame = window_start_frame + rel_end
        if self.left_context is not None:
            spf = self._SAMPLES_PER_FRAME
            keep_from = max(self._committed_frame * spf - self.left_context, self._base)
            keep_from = (keep_from // spf) * spf  # frame-aligned
            drop = keep_from - self._base
            if drop > 0:
                self._buffer = self._buffer[drop:]
                self._base = keep_from

    def feed(self, chunk: np.ndarray) -> str:
        """Append float32 audio in [-1, 1] or int16 PCM; returns the
        transcript committed so far."""
        chunk = np.asarray(chunk)
        if chunk.dtype == np.int16:
            chunk = chunk.astype(np.float32) * (1.0 / 32768.0)  # exact: a power of two
        else:
            chunk = chunk.astype(np.float32)
        self._buffer = np.concatenate([self._buffer, chunk])
        self._since_decode += len(chunk)
        if self._since_decode >= self.chunk:
            self._since_decode = 0
            total = self._base + len(self._buffer)
            self._commit_until((total - self.right_context) // self._SAMPLES_PER_FRAME)
        return self.transcript

    def finish(self) -> str:
        """Commit every remaining frame; returns the final transcript."""
        total = self._base + len(self._buffer)
        if len(self._buffer) > 0:
            # mel frames = wav_len // 160 + 1, and the strided encoder rounds
            # up: ask for one frame more than whole frames
            self._commit_until(total // self._SAMPLES_PER_FRAME + 1)
        return self.transcript


class TTSPipeline:
    """texts -> waveforms with the v2 align and audio models, on ``device``
    (default ``cuda``; ``device="cpu"`` runs the plain PyTorch path). With
    ``use_phone`` (the default) texts become CMU phones through the
    English G2P, or phones through the Japanese reader for ``language="ja"``;
    without it, English characters or romaji.

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
        self.mesh = mesh
        self.device = _serving_devices(mesh, device)[0]
        # one copy of each model a device of the mesh (the models themselves on the first)
        self._align_models, self._audio_models = (
            ([m.to(self.device)] if mesh is None else replicate(m, mesh))
            for m in (align_model, audio_model))
        for m in self._align_models + self._audio_models:
            m.eval()
        self.align_model, self.audio_model = self._align_models[0], self._audio_models[0]
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

        durations = _over_mesh(self.mesh, lambda i, *rows: self._align_models[i].predict(*rows),
                               text_t, text_len_t)
        # the one fetch of the durations: it sizes the frame bucket and feeds
        # the cursor (ops/duration.py)
        durations = durations.cpu().numpy()
        mask = np.arange(text_bucket)[None, :] < text_len[:, None]
        totals = (durations * mask[:, :, None]).sum(axis=(1, 2))
        need = int(np.max(totals)) + text_bucket + 16
        out_len = _bucket(need, self.frame_buckets)
        aligntext, aligntext_len = self.align_model.align(text_t, durations, text_len_t, out_len)
        f0, feat, codeap = _over_mesh(
            self.mesh, lambda i, *rows: self._audio_models[i].predict(*rows), aligntext,
            aligntext_len)
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
