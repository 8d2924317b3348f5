"""Port TTS v2 training (losses, compute_loss, tasks, trainer) vs the JAX package (CPU).

Narrow models (a 2-layer biLSTM with H=16, decoder blocks of 32 and 16
channels) start on both sides from the same weights
(``from_jax_variables``); the JAX biLSTM runs its scan on the CPU.
Tolerances, each with its reason:

* ``world_loss_v2`` (mse and l1) and ``duration_loss`` on the same
  arrays: rtol 1e-6 (float32 sums of a few hundred terms in another
  order), with prediction and target cropped to their common length and
  rows of length 0;
* both ``compute_loss``es on the same weights and batch: rtol 1e-5 (the
  model's float32 forward, ~1e-7 measured, under the losses' sums),
  with ``f0_len`` both below and above the decoder's ``2 L - 1`` frames;
* three steps of each model against the JAX task under
  ``optax.chain(clip_by_global_norm(1.0), adam(1e-3))``, dropout off:
  losses rtol 1e-4, parameters atol 2e-5, the bounds
  ``tests/test_torch_train.py`` argues (Adam's first steps move a weight
  by about ``lr * sign(g)``, so a near-zero gradient entry rounded
  differently moves it by a fraction of 1e-3; a wrong sign or scale
  would show as ~1e-3). The WORLD batches are drawn from the statistics
  the model normalizes by, as a corpus is after calc_stat. With targets
  tens of standard deviations off, the global norm reaches ~66, the clip
  scales every gradient by ~1/66, and entries land near Adam's eps
  (1e-8), where float32 rounding of a cancelling sum decides the step:
  one embedding entry then parts by 7.6e-5 after three steps.

Dropout draws cannot match flax's, so training mode is held to
reproducibility under one ``torch.Generator`` instead.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables
from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

VOCAB, HIDDEN, BATCH = 29, 16, 3
DECODER = ((32, False, 3, 1, 1, False), (32, True, 5, 2, 2, False), (16, False, 3, 1, 1, True))
STATS = {"f0_mean": [150.0], "f0_std": [30.0], "logspc_mean": np.linspace(-6, 0.5, 25),
         "logspc_std": np.linspace(0.2, 1.5, 25), "codeap_mean": [-20.0], "codeap_std": [6.0]}
PARAM_ATOL = 2e-5


@pytest.fixture(scope="module")
def align_pair():
    from voice100_tpu.models import TextToAlignText as JaxAlign

    model = JaxAlign(vocab_size=VOCAB, num_layers=2, hidden_size=HIDDEN)
    variables = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def audio_pair():
    from voice100_tpu.models import AlignTextToAudio as JaxAudio

    model = JaxAudio(vocab_size=VOCAB, logspc_size=25, codeap_size=1, encoder_num_layers=2,
                     encoder_hidden_size=HIDDEN, decoder_settings=DECODER)
    variables = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["world_norm"]["norm"] = {k: np.asarray(v, np.float32) for k, v in STATS.items()}
    return model, variables


def _align_model(variables):
    model = TextToAlignText(VOCAB, num_layers=2, hidden_size=HIDDEN, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _audio_model(variables):
    model = AlignTextToAudio(VOCAB, 25, 1, 2, HIDDEN, DECODER, device="cpu")
    model.load_state_dict(from_jax_variables(variables, DECODER), strict=True)
    return model


def _align_batch(rng, text_tokens=20, align_slots=33):
    """A collated duration batch: ``((text, text_len), (align, align_len))``
    with ragged lengths, an empty row, and a flat align axis of
    ``align_slots`` (odd: 2 L' + 1; shorter or longer than the text)."""
    text_len = np.asarray([text_tokens, 9, 0], np.int32)
    text = rng.integers(1, VOCAB, (BATCH, text_tokens)).astype(np.int32)
    text[np.arange(text_tokens)[None, :] >= text_len[:, None]] = 0
    align_len = np.minimum(2 * text_len + 1, align_slots).astype(np.int32)
    align = rng.integers(0, 9, (BATCH, align_slots)).astype(np.int32)
    align[np.arange(align_slots)[None, :] >= align_len[:, None]] = 0
    return (text, text_len), (align, align_len)


def _world_batch(rng, tokens=16, frames=64, f0_len=(64, 20, 0)):
    """A collated WORLD batch ``((f0, f0_len, logspc, codeap), (aligntext,
    aligntext_len))``: raw features drawn from the distribution ``STATS``
    describes (as calc_stat's statistics describe a corpus, so the
    normalized targets are of unit scale), with unvoiced frames (f0 0,
    codeap near 0) among voiced ones, zero past each length."""
    f0_len = np.asarray(f0_len, np.int32)
    valid = np.arange(frames)[None, :] < f0_len[:, None]

    def draw(stream, shape):
        return rng.normal(np.asarray(STATS[f"{stream}_mean"]), np.asarray(STATS[f"{stream}_std"]),
                          shape)

    f0 = np.where(rng.random((BATCH, frames)) < 0.3, 0.0, draw("f0", (BATCH, frames))) * valid
    logspc = draw("logspc", (BATCH, frames, 25)) * valid[:, :, None]
    codeap = np.where(rng.random((BATCH, frames, 1)) < 0.3, -1e-3,
                      np.minimum(draw("codeap", (BATCH, frames, 1)), -1.0)) * valid[:, :, None]
    text_len = np.asarray([tokens, 11, 3], np.int32)
    text = rng.integers(1, VOCAB, (BATCH, tokens)).astype(np.int32)
    text[np.arange(tokens)[None, :] >= text_len[:, None]] = 0
    return ((f0.astype(np.float32), f0_len, logspc.astype(np.float32), codeap.astype(np.float32)),
            (text, text_len))


def _t(batch):
    return tuple(tuple(torch.from_numpy(np.array(a)) for a in pair) for pair in batch)


@pytest.mark.parametrize("loss", ["mse", "l1"])
@pytest.mark.parametrize("pred_frames,lengths", [(40, (40, 17, 0)), (70, (64, 33, 0)),
                                                 (64, (0, 0, 0))],
                         ids=["pred_shorter", "pred_longer", "all_empty"])
def test_world_loss_v2_matches_jax(loss, pred_frames, lengths):
    from voice100_tpu.models.losses import world_loss_v2 as jax_loss
    from voice100_tpu_torch.models.losses import world_loss_v2

    rng = np.random.default_rng(pred_frames)
    (f0, f0_len, logspc, codeap), _ = _world_batch(rng, f0_len=lengths)
    hasf0, hascodeap = (f0 >= 30).astype(np.float32), (codeap < -0.2).astype(np.float32)
    preds = [rng.standard_normal((BATCH, pred_frames) + s).astype(np.float32)
             for s in ((), (), (25,), (1,), (1,))]
    args = [f0_len, *preds, hasf0, f0 / 100, logspc, hascodeap, codeap / 10]
    want = jax_loss(*map(jnp.asarray, args), loss=loss)
    got = world_loss_v2(*map(torch.from_numpy, args), loss=loss)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    assert (float(got.f0) == 0.0) == (sum(lengths) == 0)


@pytest.mark.parametrize("pred_tokens", [12, 20])
def test_duration_loss_matches_jax(pred_tokens):
    from voice100_tpu.models.losses import duration_loss as jax_loss
    from voice100_tpu_torch.models.losses import duration_loss

    rng = np.random.default_rng(pred_tokens)
    pred = rng.standard_normal((BATCH, pred_tokens, 2)).astype(np.float32)
    align = rng.integers(0, 9, (BATCH, pred_tokens, 2)).astype(np.int32)
    text = np.zeros((BATCH, pred_tokens), np.int32)
    for text_len in ([pred_tokens, 5, 0], [0, 0, 0]):
        text_len = np.asarray(text_len, np.int32)
        want = jax_loss(*map(jnp.asarray, (pred, align, text, text_len)))
        got = duration_loss(*map(torch.from_numpy, (pred, align, text, text_len)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("text_tokens,align_slots", [(20, 33), (12, 41), (16, 32)],
                         ids=["align_shorter", "align_longer", "even_slots"])
def test_align_compute_loss_matches_jax(align_pair, text_tokens, align_slots):
    model, variables = align_pair
    batch = _align_batch(np.random.default_rng(align_slots), text_tokens, align_slots)
    args = [a for pair in batch for a in pair]
    want = model.apply(variables, *map(jnp.asarray, args), True,
                       method=type(model).compute_loss)
    port = _align_model(variables).eval()
    with torch.no_grad():
        got = port.compute_loss(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("f0_len", [(64, 20, 0), (64, 40, 17), (20, 21, 2)],
                         ids=["bucket_longer", "above_2L", "below_2L"])
def test_audio_compute_loss_matches_jax(audio_pair, f0_len):
    model, variables = audio_pair
    batch = _world_batch(np.random.default_rng(sum(f0_len)), f0_len=f0_len)
    args = [a for pair in batch for a in pair]
    want = model.apply(variables, *map(jnp.asarray, args), True, method=type(model).compute_loss)
    port = _audio_model(variables).eval()
    with torch.no_grad():
        got = port.compute_loss(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)
    np.testing.assert_allclose(AlignTextToAudio.total_loss(got, 5.0).numpy(),
                               np.asarray(type(model).total_loss(want, 5.0)), rtol=1e-5)
    # voicing targets come from the raw features: both kinds are present
    assert 0 < float(got.hasf0) and 0 < float(got.hascodeap)


def test_metric_names_match_jax_tasks(audio_pair, align_pair):
    from voice100_tpu.training.tasks import make_task as jax_make_task

    for (model, variables), port, batch in (
            (audio_pair, _audio_model(audio_pair[1]), _world_batch(np.random.default_rng(0))),
            (align_pair, _align_model(align_pair[1]), _align_batch(np.random.default_rng(0)))):
        extra = {k: v for k, v in variables.items() if k != "params"}
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        want_loss, want, _ = jax_make_task(model).loss(variables["params"], extra, jbatch, None,
                                                      train=False)
        with torch.no_grad():
            loss, got = make_task(port).loss(_t(batch), train=False)
        assert list(got) == list(want)
        for name in got:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def _jax_trajectory(model, variables, batches):
    from voice100_tpu.training.tasks import make_task as jax_make_task

    task = jax_make_task(model)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    opt_state = optimizer.init(params)
    losses = []
    for batch in batches:
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

        def loss_fn(p):
            return task.loss(p, extra, jbatch, None, train=False)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params


def _port_steps(model, batches, train=False, generator=None):
    trainer = Trainer(TrainerConfig())
    task = make_task(model)
    state = TrainState(model, task.make_optimizer())
    losses = [float(trainer.train_step(task, state, _t(b), generator, train)["loss"])
              for b in batches]
    return losses, state


@pytest.mark.parametrize("which", ["align", "audio"])
def test_three_step_trajectory_matches_jax_task_and_optax(align_pair, audio_pair, which):
    if which == "align":
        (model, variables), make = align_pair, _align_model
        batches = [_align_batch(np.random.default_rng(10 + i)) for i in range(3)]
        settings_ = None
    else:
        (model, variables), make = audio_pair, _audio_model
        batches = [_world_batch(np.random.default_rng(20 + i)) for i in range(3)]
        settings_ = DECODER
    want_losses, want_params = _jax_trajectory(model, variables, batches)
    port = make(variables)
    losses, state = _port_steps(port, batches)
    assert state.step == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = to_jax_variables(port.state_dict(), settings_)["params"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    start = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    for path, want in flat_want.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(want), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(np.asarray(want) - start[path]).max() > 1e-4  # every tensor moved


@pytest.mark.parametrize("which", ["align", "audio"])
def test_training_mode_is_reproducible_under_one_generator(align_pair, audio_pair, which):
    if which == "align":
        make, variables = _align_model, align_pair[1]
        batches = [_align_batch(np.random.default_rng(30 + i)) for i in range(2)]
    else:
        make, variables = _audio_model, audio_pair[1]
        batches = [_world_batch(np.random.default_rng(40 + i)) for i in range(2)]
    runs = [_port_steps(make(variables), batches, train=True,
                        generator=torch.Generator().manual_seed(7))[0] for _ in range(2)]
    plain, _ = _port_steps(make(variables), batches)
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    assert runs[0] != plain


def test_identity_stats_warning(audio_pair, align_pair, tmp_path):
    from voice100_tpu_torch.training.trainer import IDENTITY_STATS_WARNING

    batches = [_t(_world_batch(np.random.default_rng(50)))]
    fresh = AlignTextToAudio(VOCAB, 25, 1, 2, HIDDEN, DECODER, device="cpu")
    runs = {"identity": fresh, "stats": _audio_model(audio_pair[1]),
            "align": _align_model(align_pair[1])}
    warned = {}
    for name, model in runs.items():
        if name == "align":
            batches = [_t(_align_batch(np.random.default_rng(51)))]
        log = tmp_path / f"{name}.jsonl"
        trainer = Trainer(TrainerConfig(log_path=str(log)))
        trainer.fit(model, batches)
        trainer.close()
        records = [json.loads(line) for line in log.read_text().splitlines()]
        warned[name] = [r for r in records if r.get("event") == "warning"]
        assert records[len(warned[name])]["event"] == "fit_start"
    assert [r["message"] for r in warned["identity"]] == [IDENTITY_STATS_WARNING]
    assert "calc_stat" in IDENTITY_STATS_WARNING and "--audio_stat" in IDENTITY_STATS_WARNING
    assert warned["stats"] == warned["align"] == []
