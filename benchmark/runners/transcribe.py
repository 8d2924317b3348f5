"""Bulk transcription: one client in a closed loop calls
``ASRPipeline.transcribe`` on lists of clips.

Every list holds the same multiset of lengths (one clip of each of the
mix's ``clips_per_call`` lengths, drawn among ``variants`` clips of that
length), so each call is the same work in another order and content; the
run's seed draws the content and the choices. Set-up runs one call and
then one batch at each bucket the window's calls use; the window calls
until its seconds are over and counts the audio of the calls that
returned. Afterwards a seeded sample of the clips transcribed, the
longest among them, is compared with the reference at the widths its
batches were padded to.

Mix keys: ``batch_size`` (the pipeline's), ``clips_per_call``,
``variants``, ``seconds``, ``size_seed``, ``sample`` (clips compared).
"""

from __future__ import annotations

import time

import numpy as np

from yardstick import harness, served, synth, window
from yardstick.trace import Spans, maybe_profile, summarize

MAX_CALLS_PER_S = 40


def run(rc: harness.RunContext) -> harness.RunResult:
    from voice100_tpu_torch.inference import ASRPipeline

    tr, device = rc.traffic, rc.device
    per_call, variants = int(tr["clips_per_call"]), int(tr["variants"])
    model, weights = harness.build_model(rc)
    pipe = ASRPipeline(model, batch_size=int(tr["batch_size"]), device=device)
    sizes = synth.pool_seconds(tr, per_call)
    rng = synth.np_rng(rc.seed, 50)
    # clip g * variants + v is a variant of length g
    pool = synth.int16_clips(np.repeat(sizes, variants), synth.torch_gen(device, rc.seed, 51),
                             device)
    groups = np.arange(per_call * variants).reshape(per_call, variants)
    n_calls = int(rc.seconds * MAX_CALLS_PER_S) + 4

    def draw_call():
        pick = groups[np.arange(per_call), rng.integers(0, variants, size=per_call)]
        return [pool[i] for i in pick[rng.permutation(per_call)]]

    calls = [draw_call() for _ in range(n_calls)]
    capture = served.Capture(pipe)
    stand_in = rc.hooks["program"](pipe=pipe, model=model) if "program" in rc.hooks else None

    # warm-up: one call, then a batch at every bucket the calls reach
    pipe.transcribe(calls[0])
    buckets = sorted({next(b for b in pipe.buckets if len(c) <= b) for c in pool})
    for b in buckets:
        fits = sorted((c for c in pool if len(c) <= b), key=len)[-int(tr["batch_size"]):]
        pipe.transcribe(fits)
    harness.sync(device)

    spans = Spans(rc.trace)
    done, audio = [], 0.0
    with maybe_profile(rc.trace, device) as prof:
        with spans.span("window"):
            harness.sync(device)
            setup_s = time.perf_counter() - rc.t_start
            t0 = time.perf_counter()
            k = 1
            while time.perf_counter() - t0 < rc.seconds:
                clips = calls[k % len(calls)]
                capture.begin(clips)
                with spans.span("transcribe"):
                    texts = pipe.transcribe(clips)
                done.append(capture.end(texts))
                audio += sum(len(c) for c in clips) / synth.SAMPLE_RATE
                k += 1
            t1 = time.perf_counter()
    window_s = t1 - t0
    peak = harness.memory_peak(device)
    summary = summarize(prof) if prof is not None else None

    # every row the window produced, its text checked against its ids
    rows, wrong_text = [], 0
    flops, infer = 0.0, []
    for call in done:
        for pos, width, ids, n, text in capture.clip_rows(call):
            clip = call["clips"][pos]
            rows.append((clip, width, ids, n))
            if call["texts"][pos] != text or text != _greedy(ids, n):
                wrong_text += 1
        if rc.trace:
            flops += served.forward_flops(rc.init_args, call["clips"])
            for chunk, width in call["batches"]:
                infer += served.infer_calls(rc.init_args, int(tr["batch_size"]), width,
                                            [call["clips"][p] for p in chunk])
    layer_ctx = {"spans": dict(spans.seconds), "trace": summary, "window_s": window_s,
                 "model_flops": flops, "infer_calls": infer}
    del pipe, model, capture
    harness.free_cuda()

    t_ref = time.perf_counter()
    sample = served.sample_rows(rows, int(tr["sample"]), synth.np_rng(rc.seed, 52))
    if stand_in:
        sample = served.stand_in_rows(rc, weights, sample, stand_in)
    checked = served.check_rows(rc, weights, sample)
    compared = {"logit_gap": checked["logit_gap"],
                "length_mismatch": checked["length_mismatch"], "text_mismatch": float(wrong_text)}
    attempted = sum(len(c["clips"]) for c in done)
    notes = {"calls": len(done), "rows_compared": len(sample),
             "reference_s": time.perf_counter() - t_ref}
    return harness.RunResult(
        end_to_end={"transcribe_audio_s_per_s": window.rate(audio, window_s)},
        attempted=attempted, failed=0, compared=compared, setup_s=setup_s,
        memory_peak_bytes=peak, layer_ctx=layer_ctx, summary=summary, notes=notes)


def _greedy(ids, n) -> str:
    from yardstick.compare import greedy_text

    return greedy_text(np.asarray(ids)[:n])
