"""HTTP serving daemon for ASR and TTS (port of ``voice100_tpu/server.py``).

A stdlib HTTP server around the batched serving pipelines of
:mod:`voice100_tpu_torch.inference`, or around any object with the same
single-item ``transcribe``/``synthesize`` methods.

Endpoints (JSON unless noted):

  GET  /healthz               -> {"status": "ok", "models": [...]}
  POST /transcribe            body: WAV bytes (or float32 PCM with an
                              X-Raw-Sample-Rate header)
                              -> {"text": "..."}
  POST /synthesize            body: {"text": "..."}
                              -> WAV bytes (16-bit PCM)

Start:
  python -m voice100_tpu_torch.server --asr_config ... --asr_ckpt ... \
      [--tts_align_config/--tts_align_ckpt \
       --tts_audio_config/--tts_audio_ckpt] [--port 8080] [--device cpu]

The models run on ``--device`` (default ``cuda``, which raises without
CUDA; ``cpu`` runs the plain PyTorch path). Checkpoints are the port's
``.pt`` files, loaded with :func:`voice100_tpu_torch.training.cli.load_model`.

Concurrent requests micro-batch: the HTTP layer is threaded, request
bodies decode in parallel, and each endpoint's :class:`MicroBatcher`
queues the decoded inputs and flushes them into one pipeline call when
the pipeline's batch is full or ``--batch_window_ms`` (default 10) after
the first. The pipelines are row-independent, so a request's result does
not depend on its neighbours. Both batchers launch on the device's
default stream (the kernels take one stream). A WAV body past the ASR
pipeline's largest bucket streams through its ``StreamingASRSession``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

__all__ = ["MicroBatcher", "SpeechServer", "cli_main"]


class _Slot:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Flush concurrent single-item requests into one batched call.

    ``fn(list_of_inputs) -> list_of_outputs`` runs on a worker thread of
    its own. A batch leaves when ``max_batch`` items are queued or
    ``flush_ms`` after the first queued item, whichever comes first.
    ``batch_sizes`` keeps the sizes of recent batches (a bounded ring).
    When a batched call fails, its items are retried one at a time, so a
    bad input fails only its own request."""

    def __init__(self, fn, max_batch: int = 8, flush_ms: float = 10.0) -> None:
        from collections import deque

        self._fn = fn
        self._max = max(1, int(max_batch))
        self._flush_s = max(0.0, flush_ms) / 1000.0
        self._items: List = []
        self._cond = threading.Condition()
        self._stop = False
        self.batch_sizes = deque(maxlen=1024)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, item):
        slot = _Slot()
        with self._cond:
            if self._stop:
                raise RuntimeError("MicroBatcher is closed")
            self._items.append((item, slot))
            self._cond.notify_all()
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5)

    def _call(self, items) -> list:
        outs = self._fn(items)
        if len(outs) != len(items):
            raise RuntimeError(f"batched fn returned {len(outs)} results for {len(items)} inputs")
        return outs

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._items and not self._stop:
                    self._cond.wait()
                if self._stop and not self._items:
                    return
                deadline = time.monotonic() + self._flush_s
                while len(self._items) < self._max and not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = self._items[:self._max]
                del self._items[:self._max]
            self.batch_sizes.append(len(batch))
            try:
                for (_, slot), out in zip(batch, self._call([item for item, _ in batch])):
                    slot.result = out
                    slot.event.set()
            except Exception as e:
                if len(batch) == 1:
                    batch[0][1].error = e
                    batch[0][1].event.set()
                    continue
                # one bad input must not fail its neighbours: each alone
                for item, slot in batch:
                    try:
                        slot.result = self._call([item])[0]
                    except Exception as item_e:
                        slot.error = item_e
                    slot.event.set()


class SpeechServer:
    """Holds the pipelines and serves them over HTTP."""

    def __init__(self, asr_pipeline=None, tts_pipeline=None, host: str = "127.0.0.1",
                 port: int = 8080, batch_window_ms: float = 10.0) -> None:
        self.asr = asr_pipeline
        self.tts = tts_pipeline
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # only the batched pipelines take lists of inputs (single-item
        # objects are called as they are); a flush is capped at the
        # pipeline's batch so that it never splits into two device batches
        self.asr_batcher = None
        if asr_pipeline is not None and hasattr(asr_pipeline, "batch_size"):
            self.asr_batcher = MicroBatcher(asr_pipeline.transcribe,
                                            max_batch=asr_pipeline.batch_size,
                                            flush_ms=batch_window_ms)
        self.tts_batcher = None
        if tts_pipeline is not None and hasattr(tts_pipeline, "frame_buckets"):
            self.tts_batcher = MicroBatcher(tts_pipeline.synthesize,
                                            max_batch=getattr(tts_pipeline, "batch_size", 8),
                                            flush_ms=batch_window_ms)

    # -- request handling -------------------------------------------------
    def _decode_audio_body(self, body: bytes, headers) -> np.ndarray:
        raw_rate = headers.get("X-Raw-Sample-Rate")
        if raw_rate:
            wav = np.frombuffer(body, np.float32)
            rate = int(raw_rate)
        else:
            from .dsp.wav import parse_wav

            # 16-bit PCM stays int16: the pipeline uploads it as it is and
            # normalises it on the device
            samples, rate = parse_wav(body, keep_int16=True)
            wav = samples[0]
        target = getattr(self.asr, "sample_rate", 16000)
        if rate != target:
            from .dsp.resample import resample

            if wav.dtype == np.int16:
                wav = wav.astype(np.float32) * (1.0 / 32768.0)
            wav = resample(wav, rate, target)
        if wav.dtype == np.int16:
            return wav
        return np.asarray(wav, np.float32)

    def handle_transcribe(self, body: bytes, headers) -> dict:
        if self.asr is None:
            raise LookupError("no ASR model loaded")
        wav = self._decode_audio_body(body, headers)
        if self.asr_batcher is not None:  # ASRPipeline, micro-batched
            text = self.asr_batcher.submit(wav)
        else:  # a single-item object with a float front end
            if wav.dtype == np.int16:
                wav = wav.astype(np.float32) * (1.0 / 32768.0)
            text = self.asr.transcribe(wav)
        return {"text": text}

    def handle_synthesize(self, body: bytes) -> bytes:
        if self.tts is None:
            raise LookupError("no TTS model loaded")
        text = json.loads(body.decode("utf-8"))["text"]
        if self.tts_batcher is not None:  # TTSPipeline, micro-batched
            wav = self.tts_batcher.submit(text)
        else:
            wav = self.tts.synthesize(text)
        from .dsp.wav import write_wav_bytes

        return write_wav_bytes(np.asarray(wav, np.float32), getattr(self.tts, "sample_rate", 16000))

    # -- server lifecycle --------------------------------------------------
    def _make_handler(server):  # noqa: N805 (closure over the server)
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, body: bytes, content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode("utf-8"), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    models = [name for name, p in (("asr", server.asr), ("tts", server.tts))
                              if p is not None]
                    self._send_json(200, {"status": "ok", "models": models})
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                try:
                    if self.path == "/transcribe":
                        self._send_json(200, server.handle_transcribe(body, self.headers))
                    elif self.path == "/synthesize":
                        self._send(200, server.handle_synthesize(body), "audio/wav")
                    else:
                        self._send_json(404, {"error": "not found"})
                except LookupError as e:
                    self._send_json(400, {"error": str(e)})
                except Exception as e:  # answer it; the server stays up
                    self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    def start(self) -> int:
        """Serve on a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for batcher in (self.asr_batcher, self.tts_batcher):
            if batcher is not None:
                batcher.close()

    def serve_forever(self) -> None:
        """:meth:`start`, then block on the serving thread."""
        self.start()
        print(f"[server] listening on {self.host}:{self.port}")
        self._thread.join()


def _parser():
    import argparse

    parser = argparse.ArgumentParser(prog="voice100-tpu-torch-serve")
    parser.add_argument("--asr_config")
    parser.add_argument("--asr_ckpt")
    parser.add_argument("--tts_align_config")
    parser.add_argument("--tts_align_ckpt")
    parser.add_argument("--tts_audio_config")
    parser.add_argument("--tts_audio_ckpt")
    parser.add_argument("--language", default="en")
    parser.add_argument("--use_phone", action="store_true")
    parser.add_argument("--beam_size", type=int, default=0,
                        help="CTC prefix beam width for /transcribe (0 = greedy); the beam "
                             "runs batched on the device (ops/ctc_beam_device.py)")
    parser.add_argument("--lm", default=None,
                        help="trigram LM .npz (tools/train_lm.py) fused into the beam; needs "
                             "--beam_size > 0")
    parser.add_argument("--lm_weight", type=float, default=0.5)
    parser.add_argument("--lm_bonus", type=float, default=0.0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--batch_window_ms", type=float, default=10.0,
                        help="micro-batch flush window: concurrent requests arriving within it "
                             "share one batched device call")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    return parser


def build_server(argv=None) -> SpeechServer:
    """The server :func:`cli_main` starts, built from its flags."""
    args = _parser().parse_args(argv)
    from .training.cli import load_model

    asr = tts = None
    if args.asr_config and args.asr_ckpt:
        from .inference import ASRPipeline

        asr = ASRPipeline(load_model(args.asr_config, args.asr_ckpt, device=args.device),
                          language=args.language, use_phone=args.use_phone, device=args.device,
                          beam_size=args.beam_size, lm=args.lm, lm_weight=args.lm_weight,
                          lm_bonus=args.lm_bonus)
    tts_flags = (args.tts_align_config, args.tts_align_ckpt, args.tts_audio_config,
                 args.tts_audio_ckpt)
    if any(tts_flags):
        if not all(tts_flags):
            raise SystemExit("TTS serving needs all four flags: --tts_align_config, "
                             "--tts_align_ckpt, --tts_audio_config, --tts_audio_ckpt")
        from .inference import TTSPipeline

        tts = TTSPipeline(load_model(args.tts_align_config, args.tts_align_ckpt, device=args.device),
                          load_model(args.tts_audio_config, args.tts_audio_ckpt, device=args.device),
                          language=args.language, use_phone=args.use_phone, device=args.device)
    if asr is None and tts is None:
        raise SystemExit("load at least one model (--asr_config/--asr_ckpt or the four "
                         "--tts_* flags)")
    return SpeechServer(asr, tts, host=args.host, port=args.port,
                        batch_window_ms=args.batch_window_ms)


def cli_main(argv=None) -> None:
    build_server(argv).serve_forever()


if __name__ == "__main__":
    cli_main()
