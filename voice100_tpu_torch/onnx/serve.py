"""Serve exported .onnx artifacts on CPU (voice100-runtime equivalent).

A copy of ``voice100_tpu/onnx/serve.py`` on the port's host modules: the
text front end, the NumPy log-mel twin, ``codec.decode_aperiodicity`` and
``synthesis_np``; nothing here runs torch. The reference delegates inference to the separate voice100-runtime
project, which feeds exported ONNX files to onnxruntime
(the reference's README.md:289-291; the intended decode flows are
documented in its skipped tests, tests/test_onnx.py there).
This module is that consumer, built on the in-repo NumPy ONNX
evaluator: load the .onnx files written by tools.export and run

  OnnxASR:  waveform -> mel -> onnx asr graph -> argmax ids ->
            decode -> merge_repeated -> text
  OnnxTTS:  text -> phonemize/tokenize -> onnx align graph ->
            durations -> host alignment expansion -> onnx tts graph ->
            (f0, logspc, codeap) -> WORLD synthesis -> waveform

When onnxruntime is installed it is used automatically; otherwise the
NumPy evaluator runs the same files.
"""

from __future__ import annotations

import numpy as np

__all__ = ["OnnxASR", "OnnxTTS", "expand_alignment_host"]


def _load_session(path: str):
    """Prefer onnxruntime when available; fall back to the in-repo
    evaluator (also when an installed onnxruntime cannot load the
    file). Returns a callable (*arrays) -> tuple(arrays)."""
    try:
        import onnxruntime as ort  # type: ignore

        sess = ort.InferenceSession(path)
        names = [i.name for i in sess.get_inputs()]

        def run(*args):
            return tuple(sess.run(None, dict(zip(names, args))))

        return run
    except ImportError:
        pass
    except Exception as e:  # incompatible ort build / unsupported op
        print(f"[onnx.serve] onnxruntime could not load {path} ({e}); "
              "using the NumPy evaluator")
    from .runtime import load_model

    return load_model(path)


class OnnxASR:
    """Transcribe waveforms with an exported ASR graph."""

    def __init__(
        self,
        model_path: str,
        language: str = "en",
        use_phone: bool = False,
        sample_rate: int = 16000,
    ) -> None:
        from ..text import get_tokenizer

        self._run = _load_session(model_path)
        self.tokenizer = get_tokenizer(language, use_phone)
        self.sample_rate = sample_rate

    def _mel(self, waveform: np.ndarray) -> np.ndarray:
        # host twin of the log-mel front-end the models trained with
        # (torch-MelSpectrogram parity; no torch on the serving host)
        from ..ops.melspec import log_mel_spectrogram_np

        return log_mel_spectrogram_np(
            waveform, sample_rate=self.sample_rate
        )

    def transcribe(self, waveform: np.ndarray) -> str:
        mel = self._mel(waveform)[None, :, :]
        mel_len = np.asarray([mel.shape[1]], np.int32)
        logits, logits_len = self._run(mel.astype(np.float32), mel_len)
        ids = np.argmax(logits[0, : int(logits_len[0])], axis=-1)
        return self.tokenizer.merge_repeated(self.tokenizer.decode(ids))

    __call__ = transcribe


def expand_alignment_host(
    text: np.ndarray, align: np.ndarray, head: int = 5, tail: int = 5
) -> np.ndarray:
    """Duration expansion on host, mirroring the serving path's
    cursor exactly (the JAX package's ops/duration._spans_v2, itself the reference
    recurrence of voice100/models/_align_v2.py:48-75): the first
    token's pre-duration is skipped, cursors floor, spans are monotone
    and non-overlapping, and every token covers at least one frame —
    so ONNX-served and directly served synthesis see the same aligned text
    (no token can be silently erased)."""
    t = float(head)
    u = 0
    spans = []
    for i in range(text.shape[0]):
        if i > 0:
            t += float(align[i, 0])
        s = max(int(np.floor(t)), u)
        u = s + 1
        t += float(align[i, 1])
        e = max(int(np.floor(t)), u)
        u = e
        spans.append((s, e))
    aligntext = np.zeros(spans[-1][1] + tail, dtype=text.dtype)
    for (s, e), token in zip(spans, text):
        aligntext[s:e] = token
    return aligntext


class OnnxTTS:
    """Synthesize waveforms with exported align + tts graphs."""

    def __init__(
        self,
        align_path: str,
        tts_path: str,
        language: str = "en",
        use_phone: bool = True,
        sample_rate: int = 16000,
    ) -> None:
        from ..text import get_phonemizer, get_tokenizer

        self._align = _load_session(align_path)
        self._tts = _load_session(tts_path)
        self.phonemizer = get_phonemizer(language, use_phone)
        self.tokenizer = get_tokenizer(language, use_phone)
        self.sample_rate = sample_rate

    def synthesize(self, text: str) -> np.ndarray:
        ids = np.asarray(
            self.tokenizer(self.phonemizer(text)), np.int32
        )[None, :]
        text_len = np.asarray([ids.shape[1]], np.int32)
        (durations,) = self._align(ids, text_len)
        aligntext = expand_alignment_host(ids[0], durations[0])[None, :]
        aligntext_len = np.asarray([aligntext.shape[1]], np.int32)
        f0, logspc, codeap = self._tts(
            aligntext.astype(np.int32), aligntext_len
        )
        # host synthesis (no torch): the exported tts graph folds mc2sp,
        # so logspc arrives full-band — derive the FFT size from it
        from ..dsp.world.codec import decode_aperiodicity
        from ..dsp.world.synthesis_np import synthesize_np

        n_fft = 2 * (logspc.shape[-1] - 1)
        spc = np.maximum(np.exp(np.asarray(logspc[0], np.float64)), 0.0)
        ap = decode_aperiodicity(
            np.asarray(codeap[0], np.float64), self.sample_rate, n_fft
        )
        wav = synthesize_np(
            f0[0], spc, ap, fs=self.sample_rate, fft_size=n_fft
        )
        return np.clip(wav, -1.0, 1.0)

    __call__ = synthesize
