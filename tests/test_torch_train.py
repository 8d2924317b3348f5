"""Port ASR v2 training slice vs the JAX package (CPU).

A narrow AudioToAlignText (two conv blocks of 32 channels, a 2-layer
biLSTM with H=16) starts on both sides from the same weights
(``from_jax_variables``) and takes three steps on the same batches with
augmentation and dropout off. The reference is the JAX trainer's
``step_body``: ``make_task(model).loss(..., train=False)`` under
``jax.grad``, then ``optax.chain(clip_by_global_norm(1.0), adam(1e-3))``,
both Adams starting from zero moments. Losses agree within rtol 1e-4.
Parameters after three steps agree within atol 2e-5 (measured
2.9e-7): Adam's first steps move each weight by about ``lr * sign(g)``,
so a gradient entry near zero whose float32 rounding differs between the
frameworks moves its weight by a fraction of ``lr = 1e-3``; 2e-5 bounds
that, while a wrong sign or scale anywhere would show as ~1e-3.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from voice100_tpu_torch.models import AudioToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables
from voice100_tpu_torch.training import (TrainState, Trainer, TrainerConfig, make_task,
                                         restore_checkpoint, save_checkpoint)
from voice100_tpu_torch.training.trainer import clip_by_global_norm

SETTINGS = ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False))
HIDDEN, VOCAB, MELS, BATCH, FRAMES = 16, 29, 64, 4, 40
PARAM_ATOL = 2e-5


@pytest.fixture(scope="module")
def jax_model():
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model = JaxModel(audio_size=MELS, vocab_size=VOCAB, encoder_settings=SETTINGS,
                     decoder_num_layers=2, decoder_hidden_size=HIDDEN)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 21, MELS)), jnp.asarray([21]))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _batches(n, seed=0):
    """Collated ``((audio, audio_len), (text, text_len))`` numpy batches:
    ragged lengths, one row with an empty target."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        audio = rng.normal(-4.0, 2.0, (BATCH, FRAMES, MELS)).astype(np.float32)
        audio_len = np.asarray([FRAMES, 33, 21, 12], np.int32)
        text_len = np.asarray([7, 5, 0, 3], np.int32)
        text = rng.integers(1, VOCAB, (BATCH, 7)).astype(np.int32)
        text[np.arange(7)[None, :] >= text_len[:, None]] = 0
        out.append(((audio, audio_len), (text, text_len)))
    return out


def _torch_batch(batch):
    return tuple(tuple(torch.from_numpy(np.array(a)) for a in pair) for pair in batch)


def _port_model(variables):
    model = AudioToAlignText(MELS, VOCAB, SETTINGS, 2, HIDDEN, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _jax_trajectory(model, variables, batches):
    from voice100_tpu.training.tasks import make_task as jax_make_task

    task = jax_make_task(model)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    params = variables["params"]
    opt_state = optimizer.init(params)
    losses = []
    for batch in batches:
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

        def loss_fn(p):
            return task.loss(p, {}, jbatch, None, train=False)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params


def _port_steps(model, batches, trainer=None, state=None, train=False, generator=None):
    trainer = trainer or Trainer(TrainerConfig())
    task = make_task(model)
    state = state or TrainState(model, task.make_optimizer())
    losses = [float(trainer.train_step(task, state, _torch_batch(b), generator, train)["loss"])
              for b in batches]
    return losses, state


def test_three_step_trajectory_matches_jax_task_and_optax(jax_model):
    model, variables = jax_model
    batches = _batches(3)
    want_losses, want_params = _jax_trajectory(model, variables, batches)
    port = _port_model(variables)
    losses, state = _port_steps(port, batches)
    assert state.step == 3 and losses[2] < losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = to_jax_variables(port.state_dict())["params"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    start = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    for path, want in flat_want.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(want), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(np.asarray(want) - start[path]).max() > 1e-4  # every tensor moved


def test_checkpoint_round_trip_continues_the_same_trajectory(jax_model, tmp_path):
    batches = _batches(3, seed=1)
    model = _port_model(jax_model[1])
    _, state = _port_steps(model, batches[:2])
    state.epoch, state.best_monitor = 1, 2.5
    save_checkpoint(str(tmp_path / "last.pt"), state)
    uninterrupted, _ = _port_steps(model, batches[2:], state=state)

    fresh = AudioToAlignText(MELS, VOCAB, SETTINGS, 2, HIDDEN, device="cpu",
                             generator=torch.Generator().manual_seed(9))
    restored = restore_checkpoint(str(tmp_path / "last.pt"),
                                  TrainState(fresh, make_task(fresh).make_optimizer()))
    assert (restored.step, restored.epoch, restored.best_monitor) == (2, 1, 2.5)
    resumed, _ = _port_steps(fresh, batches[2:], state=restored)
    assert resumed == uninterrupted


def test_gradients_reach_every_lstm_parameter_in_training_mode(jax_model):
    model = _port_model(jax_model[1]).train()
    (audio, audio_len), (text, text_len) = _torch_batch(_batches(1, seed=2)[0])
    loss = model.compute_loss(audio, audio_len, text, text_len, deterministic=False,
                              generator=torch.Generator().manual_seed(0))
    loss.backward()
    names = [n for n, _ in model.named_parameters() if n.startswith("lstm.")]
    assert len(names) == 16
    for name, param in model.named_parameters():
        assert param.grad is not None, name
        assert torch.isfinite(param.grad).all() and param.grad.abs().max() > 0, name


def test_train_step_with_augmentation_and_dropout_is_reproducible(jax_model):
    runs = []
    for _ in range(2):
        model = _port_model(jax_model[1])
        losses, _ = _port_steps(model, _batches(2, seed=3), train=True,
                                generator=torch.Generator().manual_seed(5))
        runs.append(losses)
    plain, _ = _port_steps(_port_model(jax_model[1]), _batches(2, seed=3))
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    assert runs[0] != plain


def test_fit_logs_validates_checkpoints_and_resumes(jax_model, tmp_path):
    log_path = tmp_path / "log.jsonl"
    cfg = TrainerConfig(max_epochs=2, checkpoint_dir=str(tmp_path / "ckpt"), every_n_epochs=2,
                        log_every_n_steps=1, log_path=str(log_path), seed=3)
    train = [_torch_batch(b) for b in _batches(2, seed=4)]
    val = [_torch_batch(b) for b in _batches(1, seed=5)]
    trainer = Trainer(cfg)
    state = trainer.fit(_port_model(jax_model[1]), train, val)
    trainer.close()
    assert (state.step, state.epoch) == (4, 2)
    records = [json.loads(line) for line in log_path.read_text().splitlines()]
    epochs = [r for r in records if "train_time_s" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in epochs)
    assert [r["step"] for r in records if "train_loss" in r and "train_time_s" not in r] == [1, 2, 3, 4]
    assert state.best_monitor == min(r["val_loss"] for r in epochs)
    for name in ("best.pt", "last.pt", "epoch_2.pt"):
        assert (tmp_path / "ckpt" / name).exists(), name

    cfg.max_epochs, cfg.log_path = 3, None
    resumed = Trainer(cfg).fit(_port_model(jax_model[1]), train, val,
                               restore_from=str(tmp_path / "ckpt" / "last.pt"))
    assert (resumed.step, resumed.epoch) == (6, 3)


def test_only_float32_precision_is_accepted():
    """Float32 ("32") and the JAX trainer's bf16 aliases are the only
    precisions: an unknown one still raises, naming what is taken."""
    with pytest.raises(ValueError, match="precision '8'.*'16', 'bf16', 'bfloat16', '16-mixed'"):
        Trainer(TrainerConfig(precision="8"))
    for precision in ("32", 32, "16", 16, "bf16", "bfloat16", "16-mixed"):
        Trainer(TrainerConfig(precision=precision))


@pytest.mark.parametrize("precision,bf16", [("32", False), ("16", True), ("bf16", True),
                                            ("bfloat16", True), ("16-mixed", True)])
def test_each_precision_alias_sets_the_compute_dtype(precision, bf16):
    """Each accepted precision sets the process compute dtype as the JAX
    trainer's ``fit`` does: bf16 for the four aliases, float32 (None) for
    "32", resetting an earlier bf16 setting."""
    from voice100_tpu_torch.ops.lstm import default_compute_dtype, set_default_compute_dtype

    try:
        set_default_compute_dtype(torch.bfloat16)
        Trainer(TrainerConfig(precision=precision)).apply_precision()
        assert default_compute_dtype() == (torch.bfloat16 if bf16 else None)
    finally:
        set_default_compute_dtype(None)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_follows_optax(scale):
    rng = np.random.default_rng(int(scale * 100))
    grads = [rng.standard_normal(shape).astype(np.float32) * scale for shape in ((5, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm(params, 1.0)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in grads)), rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _loader_items(n, seed):
    """In-memory ``(features, tokens)`` items of ragged lengths, as the
    feature cache gives them: float16 log-mels and int32 ids (one item
    with an empty target)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        frames = int(rng.integers(12, FRAMES + 1))
        tokens = rng.integers(1, VOCAB, size=0 if i == 3 else int(rng.integers(1, 4)))
        items.append((rng.normal(-4.0, 2.0, (frames, MELS)).astype(np.float16),
                      tokens.astype(np.int32)))
    return items


def _loader(items, **kwargs):
    from voice100_tpu_torch.data.collate import collate_audio_text
    from voice100_tpu_torch.data.loader import DataLoader

    return DataLoader(items, batch_size=BATCH, collate_fn=collate_audio_text, prefetch=0,
                      **kwargs)


def test_evaluate_weights_real_rows_only_under_pad_to_full(jax_model):
    """11 items in batches of 4: the last batch holds 3 real rows and, with
    ``pad_to_full``, one repeat, which must neither reach the loss nor
    carry weight (``voice100_tpu/training/trainer.py:807-849``)."""
    items = _loader_items(11, seed=6)
    model = _port_model(jax_model[1])
    task = make_task(model)
    state = TrainState(model, task.make_optimizer())
    trainer = Trainer(TrainerConfig())
    padded, unpadded = (trainer.evaluate(task, state, _loader(items, pad_to_full=pad))
                        for pad in (True, False))
    assert [n for _, n in _loader(items).iter_with_counts()] == [4, 4, 3]
    np.testing.assert_allclose(padded["loss"], unpadded["loss"], rtol=1e-6, atol=1e-6)
    # the same as weighting each item's batch loss by hand over the unpadded batches
    batches = list(_loader(items, pad_to_full=False))
    want = sum(task.loss(b, train=False)[0].item() * len(b[0][1]) for b in batches) / 11
    np.testing.assert_allclose(unpadded["loss"], want, rtol=1e-6)


def test_fit_sets_the_loaders_epoch_before_each_epoch(jax_model):
    """``fit`` over a shuffled loader visits each epoch's batches in the
    order the loader gives after ``set_epoch(epoch)``
    (``voice100_tpu/training/trainer.py:614``), not epoch 0's again."""
    items = _loader_items(10, seed=7)
    loader = _loader(items, shuffle=True, seed=11)
    trainer = Trainer(TrainerConfig(max_epochs=2, log_every_n_steps=100))
    seen, train_step = [], trainer.train_step

    def recording_step(task, state, batch, *args, **kwargs):
        seen.append(np.asarray(batch[0][0]).tobytes())
        return train_step(task, state, batch, *args, **kwargs)

    trainer.train_step = recording_step
    state = trainer.fit(_port_model(jax_model[1]), loader)
    assert (state.step, state.epoch) == (6, 2)
    want = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        want.append([np.asarray(b[0][0]).tobytes() for b in loader])
    assert want[0] != want[1]
    assert seen == want[0] + want[1]
