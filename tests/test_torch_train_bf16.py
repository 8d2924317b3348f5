"""The port's bf16 training (``precision="16"``) vs the JAX package (CPU).

Narrow models start on both sides from the same weights
(``tools/weights.py``) and take three steps on the same batches, dropout
and augmentation off, at bf16: the ASR model ``AudioToAlignText`` (two
conv blocks of 32 channels, a 2-layer biLSTM with H=16), the TTS
acoustic model ``AlignTextToAudio`` (a 2-layer biLSTM with H=16, decoder
Conv -> ConvTranspose -> Conv) and the TTS duration model
``TextToAlignText``. The reference is the JAX trainer's step at bf16:
``Trainer.fit``'s ``set_default_compute_dtype(jnp.bfloat16)``, the
Pallas LSTM (``VOICE100_TPU_LSTM_KERNEL=pallas``; JAX's CPU default, the
scan, rounds the recurrent product as well and is not the function the
kernels compute), each train batch through ``task.upload_cast`` as its
prefetcher casts it, then ``task.loss`` under ``jax.grad`` and
``optax.chain(clip_by_global_norm(1.0), adam(1e-3))``. The port runs
what its ``Trainer.fit`` runs a step: ``apply_precision``,
``task.upload_cast`` with the trainer's bf16 cast, ``train_step``.

Tolerances. Both sides round at the same points, so the trajectories
part by float32 sums in another order and by the bf16 value that lands
one step away from the other's. The first loss, on equal weights: rtol
1e-5 (measured 4.5e-6). Adam's first steps move a weight by about
``lr * sign(g)``, and in bf16 a gradient entry near zero is a sum of
bf16-rounded terms whose sign can follow one such step (the conv
weights' and biases' gradients are bf16 on both sides, as flax computes
them), so a few weights part by up to ``2 * lr`` a step, and the rest
by the bf16 roundings that the sums of the float32 tests' bound
(2e-5, ``tests/test_torch_train.py``) meet more often. Per tensor: the
99th percentile of the parameters' differences within 5e-5 (measured
2.8e-5 at most; a float32 step against a bf16 one parts by ~1e-3
there), at most 1% of the elements (at least 2) beyond 1e-4 (measured
3 of 1024), none beyond ``3 * 2 * lr`` = 6e-3 (measured 2.0e-3); the
later losses rtol 5e-4 (measured 1.7e-4 on the acoustic model).

The WORLD batches keep each row's f0 within its decoder's ``2 L - 1``
frames where it reaches past them: the loss then covers the decoder's
padded frames, whose LayerNorm rows are constant, and there flax's
variance (``E[x^2] - E[x]^2``) and torch's (two-pass) give gradients
that part by ~0.5% of ``1 / sqrt(eps)`` in float32 as well
(``ROADMAP.md`` §3, reference behaviour).
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import optax
import torch

from voice100_tpu_torch.models import AlignTextToAudio, AudioToAlignText, TextToAlignText
from voice100_tpu_torch.ops.lstm import default_compute_dtype, set_default_compute_dtype
from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables
from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task
from voice100_tpu_torch.training.trainer import BF16_PRECISIONS, _to_bf16

SETTINGS = ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False))
DECODER = ((32, False, 3, 1, 1, False), (32, True, 5, 2, 2, False), (16, False, 3, 1, 1, True))
HIDDEN, VOCAB, MELS, BATCH = 16, 29, 64, 4
STATS = {"f0_mean": [150.0], "f0_std": [30.0], "logspc_mean": np.linspace(-6, 0.5, 25),
         "logspc_std": np.linspace(0.2, 1.5, 25), "codeap_mean": [-20.0], "codeap_std": [6.0]}
FIRST_LOSS_RTOL = 1e-5
LOSS_RTOL = 5e-4
PARAM_P99 = 5e-5
PARAM_ATOL = 1e-4
FLIPS = 0.01
FLIP_ATOL = 3 * 2 * 1e-3


@pytest.fixture(autouse=True)
def _float32_between_tests(monkeypatch):
    monkeypatch.delenv("VOICE100_TPU_MATMUL_DTYPE", raising=False)
    set_default_compute_dtype(None)
    yield
    set_default_compute_dtype(None)


def _asr():
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model = JaxModel(audio_size=MELS, vocab_size=VOCAB, encoder_settings=SETTINGS,
                     decoder_num_layers=2, decoder_hidden_size=HIDDEN)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 21, MELS)), jnp.asarray([21]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = AudioToAlignText(MELS, VOCAB, SETTINGS, 2, HIDDEN, device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return model, variables, port, None


def _tts_audio():
    from voice100_tpu.models import AlignTextToAudio as JaxModel

    model = JaxModel(vocab_size=VOCAB, logspc_size=25, codeap_size=1, encoder_num_layers=2,
                     encoder_hidden_size=HIDDEN, decoder_settings=DECODER)
    variables = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["world_norm"]["norm"] = {k: np.asarray(v, np.float32) for k, v in STATS.items()}
    port = AlignTextToAudio(VOCAB, 25, 1, 2, HIDDEN, DECODER, device="cpu")
    port.load_state_dict(from_jax_variables(variables, DECODER), strict=True)
    return model, variables, port, DECODER


def _tts_align():
    from voice100_tpu.models import TextToAlignText as JaxModel

    model = JaxModel(vocab_size=VOCAB, num_layers=2, hidden_size=HIDDEN)
    variables = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = TextToAlignText(VOCAB, num_layers=2, hidden_size=HIDDEN, device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return model, variables, port, None


def _text(rng, lengths, width):
    lengths = np.asarray(lengths, np.int32)
    text = rng.integers(1, VOCAB, (len(lengths), width)).astype(np.int32)
    text[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return text, lengths


def _asr_batch(rng):
    audio = rng.normal(-4.0, 2.0, (BATCH, 40, MELS)).astype(np.float32)
    audio_len = np.asarray([40, 33, 21, 12], np.int32)
    return (audio, audio_len), _text(rng, [7, 5, 0, 3], 7)


def _world_batch(rng, frames=64):
    """WORLD features drawn from ``STATS`` (as after calc_stat), voiced
    and unvoiced frames, zero past each length."""
    f0_len = np.asarray([64, 20, 0, 17], np.int32)
    valid = np.arange(frames)[None, :] < f0_len[:, None]

    def draw(stream, shape):
        return rng.normal(np.asarray(STATS[f"{stream}_mean"]), np.asarray(STATS[f"{stream}_std"]),
                          shape)

    f0 = np.where(rng.random((BATCH, frames)) < 0.3, 0.0, draw("f0", (BATCH, frames))) * valid
    logspc = draw("logspc", (BATCH, frames, 25)) * valid[:, :, None]
    codeap = np.where(rng.random((BATCH, frames, 1)) < 0.3, -1e-3,
                      np.minimum(draw("codeap", (BATCH, frames, 1)), -1.0)) * valid[:, :, None]
    return ((f0.astype(np.float32), f0_len, logspc.astype(np.float32),
             codeap.astype(np.float32)), _text(rng, [16, 11, 3, 9], 16))


def _align_batch(rng, slots=33):
    text = _text(rng, [16, 9, 0, 12], 16)
    align_len = np.minimum(2 * text[1] + 1, slots).astype(np.int32)
    align = rng.integers(0, 9, (BATCH, slots)).astype(np.int32)
    align[np.arange(slots)[None, :] >= align_len[:, None]] = 0
    return text, (align, align_len)


MODELS = {"asr": (_asr, _asr_batch), "tts_audio": (_tts_audio, _world_batch),
          "tts_align": (_tts_align, _align_batch)}


def _jax_cast(a):
    """The JAX prefetcher's bf16 upload of one leaf (``trainer.py:500-513``)."""
    return a.astype(ml_dtypes.bfloat16) if getattr(a, "dtype", None) == np.float32 else a


def _jax_bf16_trajectory(model, variables, batches, monkeypatch):
    from voice100_tpu.ops.lstm import set_default_compute_dtype as jax_set_dtype
    from voice100_tpu.training import Trainer as JaxTrainer
    from voice100_tpu.training import TrainerConfig as JaxTrainerConfig
    from voice100_tpu.training.tasks import make_task as jax_make_task

    monkeypatch.setenv("VOICE100_TPU_LSTM_KERNEL", "pallas")
    task = jax_make_task(model)
    assert JaxTrainer(JaxTrainerConfig(precision="16"))._upload_bf16()
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    opt_state = optimizer.init(params)
    losses = []
    jax_set_dtype(jnp.bfloat16)
    try:
        for batch in batches:
            jbatch = jax.tree_util.tree_map(jnp.asarray, task.upload_cast(batch, _jax_cast))

            def loss_fn(p):
                return task.loss(p, extra, jbatch, None, train=False)[0]

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
    finally:
        jax_set_dtype(None)
    return losses, params


def _port_bf16_steps(port, batches):
    trainer = Trainer(TrainerConfig(precision="16"))
    trainer.apply_precision()
    task = make_task(port)
    state = TrainState(port, task.make_optimizer())
    losses = []
    for batch in batches:
        batch = tuple(tuple(torch.from_numpy(np.array(a)) for a in pair) for pair in batch)
        batch = task.upload_cast(batch, _to_bf16)
        losses.append(float(trainer.train_step(task, state, batch, train=False)["loss"]))
    return losses, state


@pytest.mark.parametrize("which", list(MODELS))
def test_three_bf16_steps_match_the_jax_trainer_step(which, monkeypatch):
    build, draw = MODELS[which]
    model, variables, port, settings = build()
    batches = [draw(np.random.default_rng(60 + i)) for i in range(3)]
    want_losses, want_params = _jax_bf16_trajectory(model, variables, batches, monkeypatch)
    losses, state = _port_bf16_steps(port, batches)
    assert state.step == 3 and default_compute_dtype() == torch.bfloat16
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    got = to_jax_variables(port.state_dict(), settings)["params"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    start = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    for path, want in flat_want.items():
        name = jax.tree_util.keystr(path)
        err = np.abs(np.asarray(flat_got[path]) - np.asarray(want))
        apart = int((err > PARAM_ATOL).sum())
        assert np.quantile(err, 0.99) <= PARAM_P99, f"{name}: p99 {np.quantile(err, 0.99):.3e}"
        assert apart <= max(2, int(FLIPS * err.size)), f"{name}: {apart} of {err.size} apart"
        assert err.max() <= FLIP_ATOL, f"{name}: {err.max():.3e}"
        assert np.abs(np.asarray(want) - start[path]).max() > 1e-4  # every tensor moved


@pytest.mark.parametrize("which", list(MODELS))
def test_bf16_steps_differ_from_float32_steps(which):
    """The mode is live: the same three steps at float32 give other
    losses, within the reduced-precision distance JAX allows its bf16 path."""
    build, draw = MODELS[which]
    batches = [draw(np.random.default_rng(70 + i)) for i in range(3)]
    bf16, _ = _port_bf16_steps(build()[2], batches)
    set_default_compute_dtype(None)
    trainer, port = Trainer(TrainerConfig()), build()[2]
    task = make_task(port)
    state = TrainState(port, task.make_optimizer())
    f32 = [float(trainer.train_step(task, state, tuple(tuple(torch.from_numpy(np.array(a))
                                                              for a in pair) for pair in b),
                                    train=False)["loss"]) for b in batches]
    assert bf16 != f32
    np.testing.assert_allclose(bf16, f32, rtol=0.1, atol=0.02)


@pytest.mark.parametrize("precision", BF16_PRECISIONS)
def test_upload_dtype_resolves_as_the_jax_trainer_does(precision):
    """``upload_dtype="auto"`` follows the precision; explicit values win
    (``tests/test_training.py:357-381``), alias by alias, against the JAX
    trainer's own ``_upload_bf16``."""
    from voice100_tpu.training import Trainer as JaxTrainer
    from voice100_tpu.training import TrainerConfig as JaxTrainerConfig

    for kwargs in ({"precision": precision}, {"precision": "32"},
                   {"precision": "32", "upload_dtype": "bfloat16"},
                   {"precision": "32", "upload_dtype": "bf16"},
                   {"precision": precision, "upload_dtype": "float32"},
                   {"precision": precision, "upload_dtype": "16"}):
        want = JaxTrainer(JaxTrainerConfig(**kwargs))._upload_bf16()
        assert Trainer(TrainerConfig(**kwargs))._upload_bf16() == want, kwargs
    assert Trainer(TrainerConfig(precision=precision))._upload_bf16()


def test_upload_cast_quantizes_inputs_never_targets():
    """Only a pair layout's first array (float32 audio features) rounds to
    bf16; int text, lengths, the duration targets and every WORLD leaf
    upload as collated, and so does a float16 feature cache
    (``tests/test_training.py:384-410``)."""
    rng = np.random.default_rng(0)
    asr = make_task(_asr()[2])
    (audio, audio_len), (text, text_len) = asr.upload_cast(_asr_batch(rng), _to_bf16)
    assert audio.dtype == torch.bfloat16
    assert audio_len.dtype == text.dtype == text_len.dtype == np.int32
    cached = rng.normal(size=(2, 5, MELS)).astype(np.float16)
    (audio16, _), _ = asr.upload_cast(((cached, audio_len), (text, text_len)), _to_bf16)
    assert audio16 is cached
    batch = _world_batch(rng)
    assert make_task(_tts_audio()[2]).upload_cast(batch, _to_bf16) is batch
    (t, _), (align, _) = make_task(_tts_align()[2]).upload_cast(_align_batch(rng), _to_bf16)
    assert t.dtype == align.dtype == np.int32
    # the device widens what was rounded back to float32
    args = asr.upload(((audio, audio_len), (text, text_len)))
    assert args[0].dtype == torch.float32
    assert torch.equal(args[0], audio.float())


def test_fit_uploads_train_batches_in_bf16_and_sets_the_mode(tmp_path):
    """``fit`` at bf16: the process mode is set, train batches reach the
    step with bf16 audio, validation batches as collated, ``fit_start``
    logs the upload; a float32 fit after it resets the mode. Train batches
    reach the step as tensors (the device prefetcher's upload)."""
    rng = np.random.default_rng(1)
    train = [_asr_batch(rng) for _ in range(2)]
    val = [_asr_batch(rng)]
    seen = []

    class Spy(Trainer):
        def train_step(self, task, state, batch, generator=None, train=True):
            seen.append((batch[0][0].dtype, default_compute_dtype()))
            return super().train_step(task, state, batch, generator, train)

    log = tmp_path / "log.jsonl"
    trainer = Spy(TrainerConfig(max_epochs=1, precision="16", log_path=str(log)))
    trainer.fit(_asr()[2], train, val)
    trainer.close()
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2
    assert isinstance(val[0][0][0], np.ndarray) and val[0][0][0].dtype == np.float32
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert records[0]["event"] == "fit_start" and records[0]["upload"] == "bf16"
    assert np.isfinite(records[-1]["val_loss"])

    seen.clear()
    Spy(TrainerConfig(max_epochs=1)).fit(_asr()[2], train, val)
    assert seen == [(torch.float32, None)] * 2
