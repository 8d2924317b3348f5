"""Served ASR under an open loop: Poisson arrivals of single WAV bodies
to ``SpeechServer.handle_transcribe`` (the body decode, the micro-batcher
at the server's defaults, ``ASRPipeline.transcribe``, the text), with no
socket in between.

Arrivals are due at a fixed rate (the cell's ``rate_per_s``); the gaps
and the clip lengths are the mix's multisets for every seed, in an order
the run's seed draws. Client threads (``clients``) each take the next
request, wait until it is due, send it and wait for its answer. A
request's latency runs from when it was due to its answer, so a sender
that runs late charges the wait; how late the senders ran is its own
metric. Every request due in the window is awaited, up to a minute past
its close. Each request's PCM carries its number in its first two
samples, so that the micro-batcher's rows can be traced to their
requests; the bodies are built in set-up, so that the senders only send.

Afterwards every answer is checked against the frame ids its row was
fetched with, and a seeded sample of the requests, the longest among
them, against the reference.

Mix keys: ``rate_per_s`` (from the cell's file), ``clients``, ``pool`` (distinct clips),
``seconds``, ``size_seed``, ``sample``, ``batch_window_ms``,
``pipeline_batch``; ``warm_s`` of load at the cell's rate before the
window.
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np

from yardstick import harness, served, synth, window
from yardstick.trace import Spans, maybe_profile, summarize

GRACE_S = 60.0


def schedule(rc, rate: float, seconds: float, key: int):
    """Due times in [0, seconds): exponential gaps of mean 1/rate drawn
    from the mix's size seed (the same for every run seed), in an order
    the run's seed draws."""
    n = int(math.ceil(rate * seconds * 1.5)) + 16
    gaps = synth.np_rng(int(rc.traffic["size_seed"]), 3, key).exponential(1.0 / rate, size=n)
    gaps = gaps[synth.np_rng(rc.seed, 60, key).permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    return due[due < seconds]


def _mark(clip: np.ndarray, number: int) -> np.ndarray:
    out = clip.copy()
    out[0], out[1] = number & 0x7FFF, (number >> 15) & 0x7FFF
    return out


def _number(wav: np.ndarray) -> int:
    return int(wav[0]) | (int(wav[1]) << 15)


class LoadGenerator:
    """Client threads over a schedule of ``(due, body)``; records each
    request's send and answer times and its answer."""

    def __init__(self, server, clients: int) -> None:
        self.server = server
        self.clients = clients

    def run(self, t0: float, due: np.ndarray, bodies):
        n = len(due)
        sent, done, answers, errors = [math.nan] * n, [math.nan] * n, [None] * n, [None] * n
        todo: "queue.Queue" = queue.Queue()
        for i in range(n):
            todo.put(i)
        headers = {"Content-Type": "audio/wav"}

        def client():
            while True:
                try:
                    i = todo.get_nowait()
                except queue.Empty:
                    return
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[i] = time.perf_counter()
                try:
                    answers[i] = self.server.handle_transcribe(bodies(i), headers)["text"]
                except Exception as err:  # counted as failed, with its reason
                    errors[i] = f"{type(err).__name__}: {err}"
                done[i] = time.perf_counter()

        threads = [threading.Thread(target=client, daemon=True) for _ in range(self.clients)]
        for th in threads:
            th.start()
        deadline = t0 + (due[-1] if n else 0.0) + GRACE_S
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        return sent, done, answers, errors, [th for th in threads if th.is_alive()]


def run(rc: harness.RunContext) -> harness.RunResult:
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.server import SpeechServer

    tr, device = rc.traffic, rc.device
    rate = float(tr["rate_per_s"])
    model, weights = harness.build_model(rc)
    pipe = ASRPipeline(model, batch_size=int(tr["pipeline_batch"]), device=device)
    pool = served.make_pool(rc, int(tr["pool"]))
    capture = served.Capture(pipe)
    spans = Spans(rc.trace)
    calls_in_window = []
    orig = pipe.transcribe

    def transcribe(items):
        capture.begin(items)
        with spans.span("server.transcribe"):
            texts = orig(items)
        calls_in_window.append(capture.end(texts))
        return texts

    pipe.transcribe = transcribe  # before the server binds it to its batcher
    server = SpeechServer(pipe, batch_window_ms=float(tr["batch_window_ms"]))
    stand_in = (rc.hooks["program"](pipe=pipe, model=model, server=server)
                if "program" in rc.hooks else None)
    load = LoadGenerator(server, int(tr["clients"]))
    try:
        # warm-up: a full batch at every bucket the pool reaches, then load
        # at the cell's rate through the server
        buckets = sorted({next(b for b in pipe.buckets if len(c) <= b) for c in pool})
        for b in buckets:
            orig(sorted((c for c in pool if len(c) <= b), key=len)[-pipe.batch_size:])
        rng = synth.np_rng(rc.seed, 61)
        warm_due = schedule(rc, rate, float(tr["warm_s"]), 1)
        warm_pick = rng.integers(0, len(pool), size=len(warm_due))
        warm_bodies = [synth.wav_bytes(pool[j]) for j in warm_pick]
        load.run(time.perf_counter(), warm_due, warm_bodies.__getitem__)
        calls_in_window.clear()

        due = schedule(rc, rate, rc.seconds, 2)
        pick = rng.integers(0, len(pool), size=len(due))
        bodies = [synth.wav_bytes(_mark(pool[pick[i]], i)) for i in range(len(due))]
        harness.sync(device)
        with maybe_profile(rc.trace, device) as prof:
            with spans.span("window"):
                setup_s = time.perf_counter() - rc.t_start
                t0 = time.perf_counter()
                sent, done, answers, errors, stuck = load.run(t0, due, bodies.__getitem__)
                t1 = time.perf_counter()
        peak = harness.memory_peak(device)
        summary = summarize(prof) if prof is not None else None
    finally:
        server.stop()

    latency = [(d - t0 - u) if not math.isnan(d) and e is None else math.inf
               for d, u, e in zip(done, due, errors)]
    late = [s - t0 - u for s, u in zip(sent, due) if not math.isnan(s)]
    failed = sum(1 for x in latency if math.isinf(x))
    thirds = np.array_split(np.asarray(latency), 3)
    p95_ms = 1e3 * window.percentile(latency, 95)

    # each answer against the ids of the row that served its request
    rows, by_request, wrong = [], {}, 0
    batch_rows, flops, infer = [], 0.0, []
    for call in calls_in_window:
        batch_rows.append(len(call["clips"]))
        for pos, width, ids, n, text in capture.clip_rows(call):
            number = _number(call["clips"][pos])
            by_request[number] = (width, ids, n, text)
        if rc.trace:
            flops += served.forward_flops(rc.init_args, call["clips"])
            for chunk, width in call["batches"]:
                infer += served.infer_calls(rc.init_args, pipe.batch_size, width,
                                            [call["clips"][p] for p in chunk])
    for i, answer in enumerate(answers):
        if answer is None:
            continue
        row = by_request.get(i)
        if row is None or row[3] != answer or answer != served_text(row):
            wrong += 1
        else:
            rows.append((_mark(pool[pick[i]], i), row[0], row[1], row[2]))
    layer_ctx = {"spans": dict(spans.seconds), "trace": summary, "window_s": t1 - t0,
                 "model_flops": flops, "infer_calls": infer, "batch_rows": batch_rows,
                 "late_s": late}
    pipe.transcribe = orig
    del pipe, model, server, capture, bodies
    harness.free_cuda()

    t_ref = time.perf_counter()
    sample = served.sample_rows(rows, int(tr["sample"]), synth.np_rng(rc.seed, 62))
    if stand_in:
        sample = served.stand_in_rows(rc, weights, sample, stand_in)
    checked = served.check_rows(rc, weights, sample)
    compared = {"logit_gap": checked["logit_gap"],
                "length_mismatch": checked["length_mismatch"], "text_mismatch": float(wrong)}
    notes = {"requests": len(due), "stuck_clients": len(stuck), "rows_compared": len(sample),
             "offered_per_s": rate, "completed_per_s": (len(due) - failed) / max(t1 - t0, 1e-9),
             "p50_ms": 1e3 * window.percentile(latency, 50), "p95_ms": p95_ms,
             "median_ms_by_third": [1e3 * float(np.median(t)) for t in thirds if len(t)],
             "errors": sorted({e for e in errors if e})[:5],
             "reference_s": time.perf_counter() - t_ref}
    return harness.RunResult(
        end_to_end={"transcribe_p95_ms": p95_ms},
        attempted=len(due), failed=failed, compared=compared, setup_s=setup_s,
        memory_peak_bytes=peak, layer_ctx=layer_ctx, summary=summary, notes=notes)


def served_text(row) -> str:
    from yardstick.compare import greedy_text

    _, ids, n, _ = row
    return greedy_text(np.asarray(ids)[:n])
