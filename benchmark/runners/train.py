"""Training cells: the trainer's streamed loop over seeded batches.

The program is driven as ``Trainer.fit`` streams an epoch: host batches
(seeded items, shuffled and not length-bucketed, collated by the port's
collate on the loader side) through ``DevicePrefetcher`` (two ahead, the
trainer's own ``_prefetcher``) into ``Trainer.train_step``, with
augmentation and dropout on, and the trainer's metrics fetch every
``log_every_n_steps`` steps as the only sync.

Set-up builds one trainer, model and optimizer state and drives them
through the first ``CHECKED_STEPS`` steps on rows that all differ, keeping
what the comparison needs (the first moment after step 1, the weights
after the last), then one step at each padded length the window will
meet; the window continues the same feed with the same objects. After
the window the reference follows the checked steps from the same weights,
batches and noise.

Mix keys: ``batch_size``, ``pool`` (items made once a run), ``seconds``
(the length mixture), ``size_seed``, ``ids_per_s`` (transcripts; ASR).
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List

import numpy as np
import torch

from yardstick import compare, harness, roofline, synth, window
from yardstick.trace import Spans, maybe_profile, summarize

MAX_STEPS_PER_S = 25  # the window's plan of batches: more than any cell runs
CHECKED_STEPS = 3     # the steps the reference follows


class Feed:
    """The host batches in order: a plan of index lists (epochs of seeded
    permutations), collated as the port's loader would, on the thread that
    iterates it (the prefetcher's)."""

    def __init__(self, items, collate, batch: int, rng: np.random.Generator, plan_len: int,
                 front: List[List[int]] = ()) -> None:
        self.items, self.collate, self.batch, self.rng = items, collate, batch, rng
        self.plan: List[List[int]] = [list(x) for x in front]
        self._perm: List[int] = []
        while len(self.plan) < plan_len:
            self.plan.append(self._draw())
        self.given = 0

    def _draw(self) -> List[int]:
        if len(self._perm) < self.batch:
            self._perm = list(self.rng.permutation(len(self.items)))
        out, self._perm = self._perm[:self.batch], self._perm[self.batch:]
        return [int(i) for i in out]

    def __iter__(self):
        while True:
            if self.given == len(self.plan):
                self.plan.append(self._draw())
            idx = self.plan[self.given]
            self.given += 1
            yield self.collate([self.items[i] for i in idx])


def _asr_items(rc, seconds, gen, rng):
    from voice100_tpu_torch.data.collate import collate_audio_text

    samples = (seconds * synth.SAMPLE_RATE).astype(np.int64)
    frames = synth.mel_frames(samples)
    feats = synth.logmel_items(frames, gen, rc.device)
    texts = synth.ctc_texts(seconds, rc.traffic["ids_per_s"], rc.init_args["vocab_size"], rng)
    return list(zip(feats, texts)), collate_audio_text, samples / synth.SAMPLE_RATE


def _tts_items(rc, seconds, gen, rng):
    from voice100_tpu_torch.data.collate import collate_world_text

    frames = np.round(seconds / synth.WORLD_FRAME_S).astype(np.int64)
    world = synth.world_items(frames, gen, rc.device, rc.init_args["logspc_size"],
                              rc.init_args["codeap_size"])
    texts = synth.aligned_texts(frames, rc.init_args["vocab_size"], rng)
    return list(zip(world, texts)), collate_world_text, frames * synth.WORLD_FRAME_S


def world_stats(items) -> Dict[str, np.ndarray]:
    """The WORLD statistics of the items (calc_stat's rule: f0 over frames
    above 30 Hz, the spectrum over every frame, codeap over frames below
    -0.2 divided by the spectrum's count)."""
    f0 = np.concatenate([w[0] for w, _ in items]).astype(np.float64)
    mc = np.concatenate([w[1] for w, _ in items]).astype(np.float64)
    cap = np.concatenate([w[2] for w, _ in items]).astype(np.float64)
    voiced = f0 > 30.0
    aper = cap < -0.2

    def mean_std(s, sq, n):
        n = np.maximum(n, 1.0)
        m = s / n
        return m, np.sqrt(np.maximum(sq / n - m ** 2, 1e-12))

    f0_m, f0_s = mean_std(f0[voiced].sum(), (f0[voiced] ** 2).sum(), voiced.sum())
    mc_m, mc_s = mean_std(mc.sum(0), (mc ** 2).sum(0), len(mc))
    cap_m, cap_s = mean_std((cap * aper).sum(0), (cap ** 2 * aper).sum(0), len(mc))
    out = {"f0_mean": [f0_m], "f0_std": [f0_s], "logspc_mean": mc_m, "logspc_std": mc_s,
           "codeap_mean": cap_m, "codeap_std": cap_s}
    return {k: np.asarray(v, np.float32).reshape(-1) for k, v in out.items()}


def _extent(n: int, size: int) -> int:
    return max(size, -(-int(n) // size) * size)


def augmented_frames(frames, time, gen_state, device):
    """The lengths the augmentation's time stretch gives a step's rows:
    its first two draws (the coin and the rate) replayed from the trainer
    generator's state before the step."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    coin = bool(torch.rand((), generator=g, device=device) < 0.2)
    rate = int(torch.randint(50, 150, (), generator=g, device=device))
    frames = np.asarray(frames, np.int64)
    return np.minimum(frames * rate // 100, time) if coin else frames


def run(rc: harness.RunContext) -> harness.RunResult:
    from voice100_tpu_torch.training.tasks import make_task
    from voice100_tpu_torch.training.trainer import Trainer, TrainerConfig

    tr, device, kind = rc.traffic, rc.device, rc.config["reference"]
    batch = int(tr["batch_size"])
    checked = CHECKED_STEPS
    phases = {"imports": time.perf_counter() - rc.t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    model, weights = harness.build_model(rc)
    phase("model")
    sizes = synth.pool_seconds(tr, int(tr["pool"]))
    rng = synth.np_rng(rc.seed, 20)
    seconds = sizes[rng.permutation(len(sizes))]
    gen = synth.torch_gen(device, rc.seed, 21)
    make_items = _asr_items if kind == "asr_v2" else _tts_items
    items, collate, audio_s = make_items(rc, seconds, gen, rng)
    stats = None
    if kind == "tts_v2":
        stats = world_stats(items)
        with torch.no_grad():
            for k, v in stats.items():
                getattr(model.norm, k).copy_(torch.from_numpy(v).reshape(-1))

    phase("data")
    trainer = Trainer(TrainerConfig(gradient_clip_val=float(rc.config["gradient_clip_val"]),
                                    seed=synth.torch_seed(rc.seed, 30)))
    trainer.apply_precision()
    task = make_task(model)
    state = trainer.make_state(task)
    generator = torch.Generator(device=device).manual_seed(trainer.config.seed)

    # the feed: the checked steps' distinct rows, one batch a padded length
    # the window meets, then the window's plan
    plan_rng = synth.np_rng(rc.seed, 23)
    order = plan_rng.permutation(len(items))
    front = [list(order[i * batch:(i + 1) * batch]) for i in range(checked)]
    window_plan = Feed(items, collate, batch, plan_rng, int(rc.seconds * MAX_STEPS_PER_S) + 8)
    if kind == "asr_v2":
        length_of = lambda i: len(items[i][0])  # noqa: E731
    else:
        length_of = lambda i: len(items[i][0][0])  # noqa: E731
    warm, seen = [], set()
    for idx in window_plan.plan:
        ext = _extent(max(length_of(i) for i in idx), 64)
        if ext not in seen:
            seen.add(ext)
            warm.append(idx)
    feed = Feed(items, collate, batch, plan_rng, 0, front + warm + window_plan.plan)
    if "feed" in rc.hooks:
        rc.hooks["feed"](feed)
    prefetcher = trainer._prefetcher(task, feed, None)
    stand_in = (rc.hooks["program"](trainer=trainer, task=task, state=state)
                if "program" in rc.hooks else None)

    spans = Spans(rc.trace)
    log_every = trainer.config.log_every_n_steps
    steps: List[dict] = []

    def one_step(record: bool):
        gen_state = generator.get_state() if record and rc.trace else None
        with spans.span("batch_wait"):
            b = next(prefetcher)
        with spans.span("step_enqueue"):
            metrics = trainer.train_step(task, state, b, generator)
        if state.step % log_every == 0:
            with spans.span("metrics_fetch"):  # the trainer's log record
                _ = [float(v) for v in metrics.values()]
        if record:
            steps.append({"idx": feed.plan[feed_pos[0]], "gen_state": gen_state})
        feed_pos[0] += 1
        return metrics

    feed_pos = [0]
    params = dict(model.named_parameters())
    losses, first_moment = [], None
    for s in range(checked):
        metrics = one_step(False)
        losses.append(metrics["loss"])
        if s == 0:
            harness.sync(device)
            phase("first_step")
            first_moment = {n: (state.optimizer.state[p]["exp_avg"].detach().clone()
                                if p in state.optimizer.state else torch.zeros_like(p))
                            for n, p in params.items()}
    after = {n: p.detach().clone() for n, p in params.items()}
    harness.sync(device)
    phase("checked_steps")
    for _ in warm:
        one_step(False)
    harness.sync(device)
    phase("warm_steps")
    spans.seconds.clear()

    audio = 0.0
    with maybe_profile(rc.trace, device) as prof:
        with spans.span("window"):
            harness.sync(device)
            setup_s = time.perf_counter() - rc.t_start
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < rc.seconds:
                one_step(True)
                audio += float(audio_s[steps[-1]["idx"]].sum())
            harness.sync(device)
            t1 = time.perf_counter()
    window_s = t1 - t0
    peak = harness.memory_peak(device)
    summary = summarize(prof) if prof is not None else None

    # per-layer context: the window's steps with their lengths
    layer_ctx = _layer_ctx(rc, kind, items, steps, spans, summary, window_s)

    prefetcher.close()
    losses = [float(x) for x in losses]
    grads = {n: m / (1.0 - 0.9) for n, m in first_moment.items()}
    lr = float(rc.init_args["learning_rate"])
    del trainer, task, state, model, prefetcher, params, first_moment
    harness.free_cuda()

    # the reference follows the checked steps; a stand-in (the control) is
    # the reference in a lower precision, read in the program's place
    t_ref = time.perf_counter()
    ref_batches = [[items[i] for i in idx] for idx in front]
    clip = float(rc.config["gradient_clip_val"])
    if stand_in:
        low = _reference_steps(rc, kind, weights, stats, ref_batches, lr, clip, stand_in)
        losses, grads, after = low["losses"], low["grads"], low["after"]
        del low
    ref = _reference_steps(rc, kind, weights, stats, ref_batches, lr, clip, "float32")
    moving = compare.moving_leaves(ref["grads"])
    compared, worst = _readings(losses, grads, after, ref, weights, moving)
    notes = {"losses": losses, "ref_losses": ref["losses"], "worst_leaves": worst,
             "leaves_left_out": sorted(set(weights) - set(moving)),
             "window_steps": len(steps), "setup_phases_s": phases,
             "reference_s": time.perf_counter() - t_ref}
    return harness.RunResult(
        end_to_end={"train_audio_s_per_s": window.rate(audio, window_s)},
        attempted=len(steps), failed=0, compared=compared, setup_s=setup_s,
        memory_peak_bytes=peak, layer_ctx=layer_ctx, summary=summary, notes=notes)


def _reference_steps(rc, kind, weights, stats, batches, lr, clip, mode):
    common = importlib.import_module("reference.common")
    ref_mod = importlib.import_module(f"reference.{kind}")
    if kind == "asr_v2":
        ref = ref_mod.ASRReference(rc.init_args, weights)
    else:
        ref = ref_mod.TTSReference(rc.init_args, weights, {
            k: torch.from_numpy(v).to(rc.device) for k, v in stats.items()})
    gen = torch.Generator(device=rc.device).manual_seed(synth.torch_seed(rc.seed, 30))
    with common.precision(mode):
        losses, grads = ref.train(batches, gen, lr, clip)
    return {"losses": losses, "grads": grads,
            "after": {n: p.detach() for n, p in ref.params.items()}}


def _readings(losses, grads, after, ref, weights, moving):
    """The three compared numbers of one side against the reference, and
    the leaves that set the two leaf gaps."""
    grad_gap, grad_leaf = compare.leaf_gap(grads, ref["grads"])
    change_gap, change_leaf = compare.leaf_gap(
        {n: after[n] - weights[n] for n in moving},
        {n: ref["after"][n] - weights[n] for n in moving})
    return ({"loss_rel": compare.loss_gap(losses, ref["losses"]), "grad_norm_gap": grad_gap,
             "change_norm_gap": change_gap}, {"grad": grad_leaf, "change": change_leaf})


def _layer_ctx(rc, kind, items, steps, spans, summary, window_s) -> dict:
    ctx = {"spans": dict(spans.seconds), "trace": summary, "window_s": window_s,
           "steps": len(steps), "init_args": rc.init_args, "reference": kind}
    if not rc.trace:
        return ctx
    args = rc.init_args
    lstm_calls, ctc_calls, flops = [], [], 0.0
    for st in steps:
        idx = st["idx"]
        if kind == "asr_v2":
            frames = np.asarray([len(items[i][0]) for i in idx])
            text_len = np.asarray([len(items[i][1]) for i in idx])
            t_pad = _extent(frames.max(), 64)
            frames = augmented_frames(frames, t_pad, st["gen_state"], rc.device)
            x_len, t_out = frames, t_pad
            for _, tp, k, s, p, _ in args["encoder_settings"]:
                x_len = roofline.conv_out(x_len, k, s, p, bool(tp))
                t_out = int(roofline.conv_out(t_out, k, s, p, bool(tp)))
            hidden = int(args["decoder_hidden_size"])
            layers = int(args["decoder_num_layers"])
            ctc_calls.append((len(idx), t_out, int(args["vocab_size"]),
                              _extent(text_len.max(), 16), x_len, text_len))
            flops += roofline.train_flops(roofline.asr_v2_forward_flops(args, frames))
        else:
            text_len = np.asarray([len(items[i][1]) for i in idx])
            t_out = _extent(text_len.max(), 16)
            x_len = text_len
            hidden = int(args["encoder_hidden_size"])
            layers = int(args["encoder_num_layers"])
            flops += roofline.train_flops(roofline.tts_v2_forward_flops(args, text_len))
        for _ in range(layers):
            lstm_calls.append((len(idx), t_out, hidden, x_len))
    ctx.update(lstm_calls=lstm_calls, ctc_calls=ctc_calls, model_flops=flops)
    return ctx
