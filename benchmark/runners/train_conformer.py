"""The ConformerCTC training cell: the protocol of ``runners/train.py``
for a model that runner does not build.

As there, the program is driven as ``Trainer.fit`` streams an epoch:
seeded host items, shuffled and not length-bucketed, collated by the
port's ``collate_audio_text`` on the loader side, through
``DevicePrefetcher`` (two ahead) into ``Trainer.train_step``, with
SpecAugment and dropout on, the metrics fetched every
``log_every_n_steps`` steps. Set-up drives the first ``CHECKED_STEPS``
steps on rows that all differ, then one step at each padded length the
window will meet; after the window the reference
(``reference/conformer_ctc.py``: float32, its CTC lattice in float64)
follows the checked steps from the same weights, batches, SpecAugment
draws and dropout masks. The ``program`` hook (``yardstick/faults.py``)
is honoured as there.

What differs, and why this runner exists beside ``train.py``:

* its own weight fill (:func:`fill_weights`): ``synth.fill_weights``
  knows no rule for ``Conv2d``, ``BatchNorm1d`` or a bare ``Parameter``
  (the position biases) and raises on them. One uniform draw on the card:
  every linear and conv within ``1/sqrt(fan_in)``, the position biases
  within ``1/sqrt(head size)``, the norms at 1 and 0;
* 80-bin float16 log-mel items (:func:`logmel_items`), transcripts of
  ``ids_per_s`` ids of the 128 non-blank units;
* the optimizer starts at the configuration's ``start_step`` (a resumed
  job at the Noam peak), and no gradient is clipped;
* ``correct`` judges the first step's loss (``loss_rel_step1``, before
  any update), the first gradient and the change after the checked
  steps; the largest gap of the three steps' losses is noted only
  (``notes["loss_rel"]``): after Adam's first update it reads as high in
  float32 as in the TF32 control;
* ``layer_ctx`` carries the model FLOPs, kernel 9's call shapes and the
  CTC lattice's (kernels 4-5, ``ctc_roofline.train``'s reader).

``Feed``, ``_extent`` and ``_readings`` come from ``runners/train.py``.

Mix keys: ``batch_size``, ``pool``, ``seconds``, ``size_seed``,
``ids_per_s``, ``mel_bins``.
"""

from __future__ import annotations

import importlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from yardstick import compare, conformer_counts, harness, roofline, spec, synth, window
from yardstick.trace import Spans, maybe_profile, summarize

_train = spec.runner("train")
Feed, _extent, _readings = _train.Feed, _train._extent, _train._readings
CHECKED_STEPS = _train.CHECKED_STEPS
MAX_STEPS_PER_S = 5  # the window's plan of batches: more than this model's steps a second


@torch.no_grad()
def fill_weights(model: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Overwrite every parameter of ``model`` from ``seed`` on its device
    (one uniform draw for the whole model); returns copies by name."""
    nn = torch.nn
    plan = []
    for module in model.modules():
        own = list(module.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)):
            kinds = {"weight": ("one", 0.0), "bias": ("zero", 0.0)}
        elif isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            b = 1.0 / math.sqrt(module.weight[0].numel())
            kinds = {"weight": ("uniform", b), "bias": ("uniform", b)}
        elif all(name.startswith("pos_bias_") for name, _ in own):
            kinds = {name: ("uniform", 1.0 / math.sqrt(p.shape[-1])) for name, p in own}
        else:
            raise ValueError(f"no initialisation rule for {type(module).__name__}")
        plan += [(p, *kinds[name]) for name, p in own]
    device = next(model.parameters()).device
    n_uni = sum(p.numel() for p, kind, _ in plan if kind == "uniform")
    uni = torch.rand(n_uni, generator=synth.torch_gen(device, seed, 11), device=device) * 2 - 1
    at = 0
    for p, kind, bound in plan:
        if kind == "uniform":
            p.copy_((uni[at:at + p.numel()] * bound).view_as(p))
            at += p.numel()
        else:
            p.fill_(1.0 if kind == "one" else 0.0)
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def logmel_items(frames, bins: int, gen: torch.Generator, device) -> List[np.ndarray]:
    """Seeded float16 log-mel items ``[frames, bins]``: ``synth.logmel_items``'s
    slow spectral tilt plus noise, at ``bins`` bands."""
    item, _ = synth._segments(frames, device)
    tilt = torch.rand(len(frames), generator=gen, device=device) * 4.0 - 6.0
    bands = torch.linspace(0.0, -3.0, bins, device=device)
    noise = torch.randn(len(item), bins, generator=gen, device=device) * 2.0
    x = (tilt[item][:, None] + bands[None, :] + noise).clamp(synth.BLANK_AUDIO, 4.0)
    return synth._split(x.to(torch.float16).cpu().numpy(), frames)


def run(rc: harness.RunContext) -> harness.RunResult:
    from voice100_tpu_torch import models
    from voice100_tpu_torch.data.collate import collate_audio_text
    from voice100_tpu_torch.training.tasks import make_task
    from voice100_tpu_torch.training.trainer import Trainer, TrainerConfig

    tr, device, args = rc.traffic, rc.device, rc.init_args
    batch = int(tr["batch_size"])
    checked = CHECKED_STEPS
    phases = {"imports": time.perf_counter() - rc.t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    model = getattr(models, rc.config["class"])(**args, device=device)
    weights = fill_weights(model, synth.torch_seed(rc.seed, 10))
    phase("model")
    sizes = synth.pool_seconds(tr, int(tr["pool"]))
    rng = synth.np_rng(rc.seed, 20)
    seconds = sizes[rng.permutation(len(sizes))]
    samples = (seconds * synth.SAMPLE_RATE).astype(np.int64)
    frames = synth.mel_frames(samples)
    feats = logmel_items(frames, int(tr["mel_bins"]), synth.torch_gen(device, rc.seed, 21), device)
    texts = synth.ctc_texts(seconds, tr["ids_per_s"], int(args["vocab_size"]), rng)
    items = list(zip(feats, texts))
    audio_s = samples / synth.SAMPLE_RATE
    phase("data")

    start = int(rc.config["start_step"])
    trainer = Trainer(TrainerConfig(gradient_clip_val=float(rc.config["gradient_clip_val"]),
                                    seed=synth.torch_seed(rc.seed, 30)))
    trainer.apply_precision()
    task = make_task(model)
    state = trainer.make_state(task)
    state.step = start
    generator = torch.Generator(device=device).manual_seed(trainer.config.seed)

    plan_rng = synth.np_rng(rc.seed, 23)
    order = plan_rng.permutation(len(items))
    front = [list(order[i * batch:(i + 1) * batch]) for i in range(checked)]
    window_plan = Feed(items, collate_audio_text, batch, plan_rng,
                       int(rc.seconds * MAX_STEPS_PER_S) + 8)
    warm, seen = [], set()
    for idx in window_plan.plan:
        ext = _extent(max(len(items[i][0]) for i in idx), 64)
        if ext not in seen:
            seen.add(ext)
            warm.append(idx)
    feed = Feed(items, collate_audio_text, batch, plan_rng, 0, front + warm + window_plan.plan)
    if "feed" in rc.hooks:
        rc.hooks["feed"](feed)
    prefetcher = trainer._prefetcher(task, feed, None)
    stand_in = (rc.hooks["program"](trainer=trainer, task=task, state=state)
                if "program" in rc.hooks else None)

    spans = Spans(rc.trace)
    log_every = trainer.config.log_every_n_steps
    steps: List[list] = []
    feed_pos = [0]

    def one_step(record: bool):
        with spans.span("batch_wait"):
            b = next(prefetcher)
        with spans.span("step_enqueue"):
            metrics = trainer.train_step(task, state, b, generator)
        if state.step % log_every == 0:
            with spans.span("metrics_fetch"):  # the trainer's log record
                _ = [float(v) for v in metrics.values()]
        if record:
            steps.append(feed.plan[feed_pos[0]])
        feed_pos[0] += 1
        return metrics

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
                audio += float(audio_s[steps[-1]].sum())
            harness.sync(device)
            t1 = time.perf_counter()
    window_s = t1 - t0
    peak = harness.memory_peak(device)
    summary = summarize(prof) if prof is not None else None
    layer_ctx = _layer_ctx(rc, items, steps, spans, summary, window_s)

    prefetcher.close()
    losses = [float(x) for x in losses]
    grads = {n: m / (1.0 - 0.9) for n, m in first_moment.items()}
    del trainer, task, state, model, prefetcher, params, first_moment
    harness.free_cuda()

    # the reference follows the checked steps; a stand-in (the control) is
    # the reference in a lower precision, read in the program's place
    t_ref = time.perf_counter()
    ref_batches = [[items[i] for i in idx] for idx in front]
    if stand_in:
        low = _reference_steps(rc, weights, ref_batches, start, stand_in)
        losses, grads, after = low["losses"], low["grads"], low["after"]
        del low
        harness.free_cuda()
    ref = _reference_steps(rc, weights, ref_batches, start, "float32")
    moving = compare.moving_leaves(ref["grads"])
    compared, worst = _readings(losses, grads, after, ref, weights, moving)
    # the losses of steps 2 and 3 follow Adam's first updates, which move
    # every element whose gradient is near round-off by +-lr: float32 and
    # the TF32 control read alike there, so only step 1's loss is judged
    loss_rel = compared.pop("loss_rel")
    compared["loss_rel_step1"] = compare.loss_gap(losses[:1], ref["losses"][:1])
    notes = {"loss_rel": loss_rel, "losses": losses, "ref_losses": ref["losses"],
             "worst_leaves": worst,
             "leaves_left_out": sorted(set(weights) - set(moving)),
             "window_steps": len(steps), "setup_phases_s": phases,
             "reference_s": time.perf_counter() - t_ref}
    return harness.RunResult(
        end_to_end={"train_audio_s_per_s": window.rate(audio, window_s)},
        attempted=len(steps), failed=0, compared=compared, setup_s=setup_s,
        memory_peak_bytes=max(peak, harness.memory_peak(device)), layer_ctx=layer_ctx,
        summary=summary, notes=notes)


def _reference_steps(rc, weights, batches, start, mode):
    common = importlib.import_module("reference.common")
    ref_mod = importlib.import_module(f"reference.{rc.config['reference']}")
    cfg = {k: v for k, v in rc.init_args.items() if k not in ("audio_size", "vocab_size")}
    ref = ref_mod.ConformerReference(cfg, weights)
    gen = torch.Generator(device=rc.device).manual_seed(synth.torch_seed(rc.seed, 30))
    with common.precision(mode):
        losses, grads = ref.train(batches, gen, start)
    return {"losses": losses, "grads": grads,
            "after": {n: p.detach() for n, p in ref.params.items()}}


def _layer_ctx(rc, items, steps, spans, summary, window_s) -> dict:
    ctx = {"spans": dict(spans.seconds), "trace": summary, "window_s": window_s,
           "steps": len(steps), "init_args": rc.init_args, "reference": rc.config["reference"]}
    if not rc.trace:
        return ctx
    args = rc.init_args
    heads, layers = int(args["n_heads"]), int(args["n_layers"])
    head_dim = int(args["d_model"]) // heads
    attn_calls, ctc_calls, flops, valid = [], [], 0.0, 0.0
    for idx in steps:
        frames = np.asarray([len(items[i][0]) for i in idx])
        text_len = np.asarray([len(items[i][1]) for i in idx])
        t_sub = int(conformer_counts.subsampled(_extent(frames.max(), 64)))
        lengths = conformer_counts.subsampled(frames)
        attn_calls += [(len(idx), t_sub, heads, head_dim, lengths)] * layers
        ctc_calls.append((len(idx), t_sub, int(args["vocab_size"]),
                          _extent(text_len.max(), 16), lengths, text_len))
        valid += layers * heads * float(np.sum(lengths.astype(np.float64) ** 2))
        flops += roofline.train_flops(conformer_counts.forward_flops(args, frames))
    ctx.update(attn_calls=attn_calls, ctc_calls=ctc_calls, model_flops=flops,
               valid_attn_pairs=valid)
    return ctx
