"""ConformerCTC against the plain NeMo-style reference
(``tests/reference_conformer_ctc.py``) at a small size on the CPU (d=64,
2 heads, 2 blocks, 16 mels, ragged lengths), that ``chip_smoke.py``
drives the benchmark cell's model and shapes, and kernel 9 against its
plain version on a card (tests marked ``card`` skip without one).

Tolerances: the port and the reference compute the same float32 ops on
the CPU, in places in another order (the dropout's scale, the GLU's
layout, SpecAugment's masks in one pass against row by row), so values
agree to a few float32 ulps of the larger terms: 1e-5 relative. Kernel 9
sums its dot products in another order than cuBLAS's batched matmuls
(online softmax, the positional gradient over atomics): 2e-5 of each
result's largest element, 20x the largest gap seen at the cell's shapes
(8.9e-7 to 1.7e-6 on an H100).
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads for the workers)

import importlib
import inspect
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import reference_conformer_ctc as ref_mod
from voice100_tpu_torch.models import ConformerCTC
from voice100_tpu_torch.models.conformer_ctc import noam_lr
from voice100_tpu_torch.ops.augment import apply_spec_augment, draw_spec_augment
from voice100_tpu_torch.ops.relpos_attention import (keep_mask, rel_shift,
                                                     relpos_attention_plain)
from voice100_tpu_torch.training.tasks import make_task
from voice100_tpu_torch.training.trainer import Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(audio_size=16, vocab_size=11, d_model=64, n_heads=2, n_layers=2,
             ff_expansion_factor=4, conv_kernel_size=7, dropout=0.1, dropout_att=0.1,
             dropout_pre_encoder=0.1, warmup_steps=100, peak_lr=2.0, min_lr=1e-6)
LENGTHS = [61, 44, 13, 57]
RTOL = 1e-5


def _model(seed=0):
    model = ConformerCTC(**SMALL, device="cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():  # seeded position biases and norms (NeMo's start at 0 and 1)
        for name, p in model.named_parameters():
            if "pos_bias" in name or "norm" in name:
                one = 1.0 if "norm" in name and name.endswith("weight") else 0.0
                p.copy_(torch.randn(p.shape, generator=g) * 0.3 + one)
    return model


def _weights(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _reference(model):
    cfg = {k: v for k, v in SMALL.items() if k not in ("audio_size", "vocab_size")}
    return ref_mod.ConformerReference(cfg, _weights(model))


def _batch(seed=1, lengths=LENGTHS, time=64, labels=6):
    g = torch.Generator().manual_seed(seed)
    audio = torch.randn(len(lengths), time, SMALL["audio_size"], generator=g) * 2 - 4
    audio_len = torch.tensor(lengths)
    valid = torch.arange(time)[None, :, None] < audio_len[:, None, None]
    audio = torch.where(valid, audio, math.log(1e-6))
    text = torch.randint(1, SMALL["vocab_size"], (len(lengths), labels), generator=g)
    text_len = torch.tensor([min(labels, max(1, n // 12)) for n in lengths])
    return audio, audio_len, text, text_len


def _close(a, b, rtol=RTOL):
    scale = max(float(b.detach().abs().max()), 1e-30)
    return float((a.detach() - b.detach()).abs().max()) <= rtol * scale


def _median_scale(grads):
    return sorted(float(g.abs().max()) for g in grads)[len(grads) // 2]


def _flat(grads):
    """Leaves whose gradient is round-off: a thousandth of the median
    leaf's or less (the keys' bias, which the softmax ignores; the
    depthwise conv's bias, which the BatchNorm after it takes out)."""
    med = _median_scale(list(grads.values()))
    return {n for n, g in grads.items() if float(g.abs().max()) <= 1e-3 * med}


def _grads_close(got, ref, rtol):
    """Each leaf's gradient within ``rtol`` of the larger of its own
    largest element and the median leaf's."""
    med = _median_scale(list(ref.values()))
    for name, g in ref.items():
        scale = max(float(g.abs().max()), med)
        assert float((got[name] - g).abs().max()) <= rtol * scale, name


def test_logits_and_lengths_match_the_reference():
    model = _model().eval()
    audio, audio_len, *_ = _batch()
    logits, lengths = model(audio, audio_len)
    ref_logits, ref_lengths = _reference(model).forward(audio, audio_len)
    assert lengths.tolist() == ref_lengths.tolist() == [16, 11, 4, 15]
    assert logits.shape == (4, 16, SMALL["vocab_size"])
    assert _close(logits, ref_logits)


def test_mean_batch_ctc_loss_matches_the_reference():
    model = _model().eval()
    batch = _batch()
    loss = model.compute_loss(*batch, deterministic=True)
    ref = _reference(model).loss(*batch, train=False)
    assert abs(float(loss) - float(ref)) <= RTOL * abs(float(ref))
    # mean_batch: the batch mean of the rows' losses, not divided by target length
    logits, lengths = model(batch[0], batch[1])
    rows = torch.nn.functional.ctc_loss(torch.log_softmax(logits, -1).transpose(0, 1), batch[2],
                                        lengths, batch[3], reduction="none", zero_infinity=True)
    assert abs(float(loss) - float(rows.mean())) <= RTOL * abs(float(rows.mean()))


def test_every_leaf_gradient_matches_the_reference_with_dropout_and_spec_augment():
    model = _model().train()
    reference = _reference(model)
    batch = _batch()
    loss = model.compute_loss(*batch, deterministic=False,
                              generator=torch.Generator().manual_seed(5))
    loss.backward()
    ref_loss = reference.loss(*batch, generator=torch.Generator().manual_seed(5))
    ref_loss.backward()
    assert abs(float(loss) - float(ref_loss)) <= RTOL * abs(float(ref_loss))
    ref_grads = {n: p.grad for n, p in reference.params.items()}
    _grads_close({n: p.grad for n, p in model.named_parameters()}, ref_grads, 1e-4)
    assert {n.split(".", 2)[2] for n in _flat(ref_grads)} == {"self_attn.linear_k.bias",
                                                              "conv.depthwise_conv.bias"}


def test_one_adamw_noam_step_through_the_trainer_matches_the_reference():
    model = _model()
    weights = _weights(model)
    reference = _reference(model)
    trainer = Trainer(TrainerConfig(gradient_clip_val=0.0, seed=7))
    task = make_task(model)
    state = trainer.make_state(task)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert state.optimizer.defaults["betas"] == (0.9, 0.98)
    state.step = 100  # the Noam peak of the small settings
    batches = [_batch(seed=s) for s in (1, 2)]
    prefetcher = trainer._prefetcher(task, iter([((a, al), (t, tl)) for a, al, t, tl in batches]),
                                     None)
    gen = torch.Generator().manual_seed(trainer.config.seed)
    losses = [float(trainer.train_step(task, state, next(prefetcher), gen)["loss"])
              for _ in batches]
    prefetcher.close()
    ref_losses, ref_first = reference.train(batches, torch.Generator().manual_seed(7),
                                            start_step=100)
    assert state.step == 102
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= 1e-4 * abs(b)
    # each leaf's change by its norm, as the benchmark compares it: Adam
    # moves an element whose gradient is round-off by +-lr either way, and
    # the flat leaves (whose gradients are all round-off) are left out
    flat = _flat(ref_first)
    for name, p in model.named_parameters():
        if name not in flat:
            change = (p.detach() - weights[name]).norm()
            ref_change = (reference.params[name].detach() - weights[name]).norm()
            assert abs(float(change - ref_change)) <= 1e-3 * float(ref_change), name


def test_batch_norm_statistics_take_the_padded_frames():
    model = _model().train()
    reference = _reference(model)
    batch = _batch()
    model.compute_loss(*batch, deterministic=False, generator=torch.Generator().manual_seed(3))
    reference.loss(*batch, generator=torch.Generator().manual_seed(3))
    for i in range(SMALL["n_layers"]):
        bn = model.layers[i].conv.batch_norm
        ref_mean = reference.buffers[f"layers.{i}.conv.batch_norm.running_mean"]
        ref_var = reference.buffers[f"layers.{i}.conv.batch_norm.running_var"]
        assert _close(bn.running_mean, ref_mean, 1e-4) and _close(bn.running_var, ref_var, 1e-4)
    # the statistics over every frame are not those over the valid frames alone
    model.eval()
    x = torch.randn(2, 10, SMALL["d_model"])
    valid = torch.tensor([[True] * 10, [True] * 4 + [False] * 6])
    conv = model.layers[0].conv
    y = torch.nn.functional.glu(conv.pointwise_conv1(x), dim=-1).masked_fill(~valid[:, :, None], 0)
    y = conv.depthwise_conv(y.transpose(1, 2))
    every = y.mean((0, 2))
    only_valid = y.transpose(1, 2)[valid].mean(0)
    assert not torch.allclose(every, only_valid)


def test_spec_augment_replays_from_the_same_draws():
    audio = torch.randn(4, 300, 80) - 3
    audio_len = torch.tensor([300, 211, 40, 19])
    draws = draw_spec_augment(torch.Generator().manual_seed(11), 4)
    got = apply_spec_augment(audio, audio_len, draws)
    u = torch.rand(4, 24, generator=torch.Generator().manual_seed(11))
    assert torch.equal(u, draws["spec"])
    assert torch.equal(got, ref_mod.spec_augment(audio, audio_len, u))
    masked = got == 0
    assert masked.any() and not masked.all()


def test_padded_rows_leave_the_valid_rows_unchanged():
    model = _model().eval()
    audio, audio_len, *_ = _batch(lengths=[37, 30], time=40)
    alone, alone_len = model(audio[:1, :40], audio_len[:1])
    longer = torch.full((2, 96, SMALL["audio_size"]), math.log(1e-6))
    longer[:, :40] = audio
    longer[1, :90] = torch.randn(90, SMALL["audio_size"])
    both, both_len = model(longer, torch.tensor([37, 90]))
    n = int(alone_len[0])
    assert int(both_len[0]) == n
    assert _close(both[0, :n], alone[0, :n])


def test_shift_selects_row_t_minus_1_minus_i_plus_j():
    x = torch.randn(2, 3, 7, 13)
    i = torch.arange(7)[:, None]
    j = torch.arange(7)[None, :]
    assert torch.equal(rel_shift(x), x[..., i, 7 - 1 - i + j])


def test_noam_rates_at_steps_1_10000_and_50000():
    peak = 2.0 / math.sqrt(512)
    assert noam_lr(1, 512, 2.0, 10000, 1e-6) == pytest.approx(peak * 1e-6, rel=1e-12)
    assert noam_lr(10000, 512, 2.0, 10000, 1e-6) == pytest.approx(peak * 0.01, rel=1e-12)
    assert noam_lr(10000, 512, 2.0, 10000, 1e-6) == pytest.approx(8.838834764831844e-4)
    assert noam_lr(50000, 512, 2.0, 10000, 1e-6) == pytest.approx(peak / math.sqrt(50000),
                                                                    rel=1e-12)
    assert noam_lr(0, 512, 2.0, 10000, 1e-6) == noam_lr(1, 512, 2.0, 10000, 1e-6)
    assert noam_lr(10 ** 11, 512, 2.0, 10000, 1e-6) == 1e-6
    model = _model()
    task = make_task(model)
    task.make_optimizer()
    assert task.lr_schedule(100) == noam_lr(100, 64, 2.0, 100, 1e-6)


def test_parameter_count_at_the_published_widths():
    model = ConformerCTC(device="cpu")
    n = sum(p.numel() for p in model.parameters())
    print(f"ConformerCTC Large: {n} parameters")
    assert 121_000_000 < n < 122_000_000
    assert sum(p.numel() for p in model.layers[0].parameters()) == 6_323_712


def _bench_reference():
    """``benchmark/reference/conformer_ctc.py``, imported as the benchmark
    imports it (``reference.conformer_ctc``, the benchmark's folder first
    on the path)."""
    saved = list(sys.path)
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        return importlib.import_module("reference.conformer_ctc")
    finally:
        sys.path[:] = saved


def test_the_benchmarks_reference_copy_matches_the_tests_reference():
    bench = _bench_reference()
    model = _model()
    cfg = {k: v for k, v in SMALL.items() if k not in ("audio_size", "vocab_size")}
    ours = ref_mod.ConformerReference(cfg, _weights(model))
    theirs = bench.ConformerReference(cfg, _weights(model))
    batch = _batch()
    loss = ours.loss(*batch, generator=torch.Generator().manual_seed(9))
    loss.backward()
    bench_loss = theirs.loss(*batch, generator=torch.Generator().manual_seed(9))
    bench_loss.backward()
    assert abs(float(loss) - float(bench_loss)) <= RTOL * abs(float(loss))
    _grads_close({n: p.grad for n, p in theirs.params.items()},
                 {n: p.grad for n, p in ours.params.items()}, 1e-4)


def test_chip_smoke_drives_the_benchmark_cell_at_its_shapes():
    saved = list(sys.path)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path[:] = saved
    config = json.loads((ROOT / "benchmark/configs/conformer_ctc_large.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/train_librispeech_conformer.json").read_text())
    args = config["init_args"]
    defaults = inspect.signature(ConformerCTC).parameters
    assert {k: defaults[k].default for k in args} == args  # the smoke's model is the cell's
    assert chip_smoke.CONFORMER_BATCH == traffic["batch_size"] == config["batch_size"]
    assert chip_smoke.CONFORMER_MELS == args["audio_size"] == traffic["mel_bins"]
    assert chip_smoke.CONFORMER_HEADS == args["n_heads"] == args["d_model"] // 64
    assert chip_smoke.CONFORMER_START_STEP == config["start_step"]
    frames, extent, time, seconds = chip_smoke.conformer_lengths(np.random.default_rng(0))
    assert (extent, time) == (1728, 432)  # the cell's longest clip, 16.7 s
    assert seconds.min() >= traffic["seconds"]["range"][0]
    assert seconds.max() == traffic["seconds"]["range"][1]


# -- kernel 9 on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 9 runs on CUDA only")
    return torch.device("cuda:0")


def _attention_case(device, batch, time, heads, lengths, drop, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(batch, time, heads, 64, generator=g, device=device) for _ in range(3))
    p = torch.randn(2 * time - 1, heads, 64, generator=g, device=device)
    u, vb = (torch.randn(heads, 64, generator=g, device=device) * 0.3 for _ in range(2))
    lengths = torch.tensor(lengths, device=device)
    keep = keep_mask((batch, heads, time, time), 0.1, g, device) if drop else None
    valid = torch.arange(time, device=device)[None, :] < lengths[:, None]
    dout = torch.randn(batch, time, heads, 64, generator=g, device=device) * valid[:, :, None, None]
    return (q, k, v, p, u, vb), lengths, keep, dout


@pytest.mark.card
@pytest.mark.parametrize("batch,time,drop", [(64, 418, True), (8, 100, True), (4, 418, False)])
def test_kernel_9_matches_the_plain_version(cuda_device, batch, time, drop):
    from voice100_tpu_torch.ops import relpos_attention_cuda as kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    lengths = ([time] * (batch // 2) + [max(1, time - 7 * i) for i in range(batch - batch // 2)])
    lengths[-1] = 1
    inputs, lengths, keep, dout = _attention_case(cuda_device, batch, time, 8, lengths, drop)
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref = relpos_attention_plain(*ref_leaves, lengths, keep, 0.1 if drop else 0.0)
    ref.backward(dout)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    before = (kernel.relpos_attention_fwd_cuda.launches, kernel.relpos_attention_bwd_cuda.launches)
    out = kernel.relpos_attention_cuda(*leaves, lengths, keep, 0.1 if drop else 0.0)
    out.backward(dout)
    torch.cuda.synchronize()
    assert kernel.relpos_attention_fwd_cuda.launches == before[0] + 1
    assert kernel.relpos_attention_bwd_cuda.launches == before[1] + 2
    assert _close(out, ref, 2e-5)
    assert float(out[-1, 1:].abs().max()) == 0  # a padded query row attends to nothing
    for name, a, b in zip(("q", "k", "v", "p", "u", "v_b"), leaves, ref_leaves):
        assert _close(a.grad, b.grad, 2e-5), name


@pytest.mark.card
def test_a_conformer_step_on_the_card_runs_kernel_9_and_matches_the_cpu(cuda_device):
    from voice100_tpu_torch.ops import relpos_attention_cuda as kernel

    cfg = dict(SMALL, d_model=128, n_heads=2)
    cpu = ConformerCTC(**cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = ConformerCTC(**cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    batch = _batch()
    before = (kernel.relpos_attention_fwd_cuda.launches, kernel.relpos_attention_bwd_cuda.launches)
    cpu.eval(), card.eval()
    loss_cpu = cpu.compute_loss(*batch)
    loss_card = card.compute_loss(*(t.to(cuda_device) for t in batch))
    loss_cpu.backward()
    loss_card.backward()
    assert kernel.relpos_attention_fwd_cuda.launches == before[0] + cfg["n_layers"]
    assert kernel.relpos_attention_bwd_cuda.launches == before[1] + 2 * cfg["n_layers"]
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-4 * abs(float(loss_cpu))
    _grads_close({n: p.grad.cpu() for n, p in card.named_parameters()},
                 {n: p.grad for n, p in cpu.named_parameters()}, 1e-3)
