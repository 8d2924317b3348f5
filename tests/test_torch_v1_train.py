"""Training the port's v1 model family vs the JAX package (CPU).

* Three-step trajectories from the same weights (``tools/weights.py``)
  on the same batches against the JAX task and optax, with the machinery
  and tolerances of ``tests/test_torch_train.py`` (losses rtol 1e-4,
  parameters atol 2e-5): ``AudioToTextCTC`` with ``steps_per_epoch=2``,
  so the staircase (``lr * 0.98 ** (step // 2)``) falls inside the
  trajectory, under AdamW with weight decay 4e-5 on every parameter, its
  BatchNorms on batch statistics (augmentation and dropout off on both
  sides, as ``tests/test_torch_v1_models.py`` turns them off) and the
  running averages of the first step at rtol 1e-5; ``AudioAlignCTC``
  (``train=False``) elementwise; ``AlignTextToAudioModel`` in training
  mode, with its running averages. With BatchNorms in training mode some
  directions of the loss are flat (``FLAT``: a bias whose shift a later
  BatchNorm absorbs, a scale that ReLU6 and a depthwise conv carry to the
  next BatchNorm): both sides' gradients there are round-off (checked),
  and Adam steps them by up to ``lr`` either way, so those tensors are
  held to Adam's reach, 6e-3 in 3 steps, alone; every other tensor to
  2e-5 at its 99th percentile, with at most 1% of its elements (at least
  2) beyond (measured: one element of 1024 at 7.3e-5, where the flat
  tensors part by up to 9.7e-4).
* ``collate_world_text_target`` byte-equal to JAX's, and the multi-task
  data module's batches and ``target_vocab_size`` equal to the JAX
  module's.
* The five train-v1 CLIs on the dummy corpus at ``--hidden_size 8``,
  mirroring ``tests/test_v1_cli.py``, plus a ``--resume_from_checkpoint``
  run; the unified CLI's v1 branches (``validate``, ``predict``) and the
  align tool with ``AudioAlignCTC``.
* ``steps_per_dispatch`` chunks over the device cache equal per-step
  training bit for bit for ``AudioToTextCTC`` (weights and BatchNorm
  running averages).
* Two gloo ranks at batch 2 against one process at batch 4 for
  ``AudioToTextCTC``, augmentation and dropout on, at the bounds of
  ``tests/test_torch_distributed.py`` (losses rtol 1e-5; weights rtol
  2e-5 / atol 2e-6 under the policy above, the flat tensors within
  Adam's reach; measured: 3 elements of 16384 of the first conv beyond,
  by 2.6e-5) and the running averages at rtol 1e-3 / atol 1e-3 (a
  running mean behind a flat shift carries its round-off, ~1e-4). The
  ranks' BatchNorms normalize by the global batch's statistics; the
  data shows that rank-local statistics would part from the global
  batch's loss by far more than the loss bound.
* ``AudioAlignCTC`` at ``precision="16"`` (its biLSTM's bf16 kernels'
  twins) against the JAX trainer's bf16 step, at the bounds of
  ``tests/test_torch_train_bf16.py``.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import re

import flax.linen
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import optax
import torch

import torch_dist_worker as worker
from corpus_fixture import make_dummy_corpus
from test_torch_distributed import (LOSS_RTOL, W_ATOL, W_RTOL, _assert_same_run, _records,
                                    _weights, _worker_ranks)
from test_torch_train import PARAM_ATOL, _batches
from test_torch_train_bf16 import (FIRST_LOSS_RTOL, FLIP_ATOL, FLIPS, LOSS_RTOL as BF16_LOSS_RTOL,
                                   PARAM_ATOL as BF16_PARAM_ATOL, PARAM_P99)
from voice100_tpu_torch import models as P
from voice100_tpu_torch.ops.lstm import set_default_compute_dtype
from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables
from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task
from voice100_tpu_torch.training.trainer import _to_bf16

MELS, VOCAB, HIDDEN = 64, 29, 16
STATS_RTOL, STATS_ATOL = 1e-5, 1e-7
# Directions BatchNorm makes flat: the output BatchNorm's bias of encoder
# blocks 0-7, whose shift the next non-residual block's conv and BatchNorm
# absorb (blocks 4 and 8), and the expand stage's BatchNorm scale, which
# ReLU6 and the depthwise conv carry to the next BatchNorm unchanged,
# except where a value reaches the clip at 6. Measured on the first step
# of the tiny AudioToTextCTC: their gradients at most 3e-7 and 1.2e-4
# against a largest gradient of 4.6; every other tensor's above 0.1.
FLAT = re.compile(r"(encoder\.layers\.[0-7]\.conv\.3\.bias|conv\.0\.1\.weight)$")
FLAT_GRAD = 1e-4
# Adam's reach in 3 steps: two updates of up to lr a step that part in sign
FLAT_ATOL = 3 * 2 * 1e-3
ASR_ARGS = dict(audio_size=MELS, vocab_size=VOCAB, embed_size=HIDDEN, hidden_size=HIDDEN)
ALIGN_ARGS = dict(audio_size=MELS, vocab_size=VOCAB, hidden_size=HIDDEN)
TTS_ARGS = dict(vocab_size=VOCAB, hidden_size=HIDDEN, use_mcep=True)
STATS = {"f0_mean": [150.0], "f0_std": [30.0], "logspc_mean": np.linspace(-6, 0.5, 25),
         "logspc_std": np.linspace(0.2, 1.5, 25), "codeap_mean": [-20.0], "codeap_std": [6.0]}


class _Identity(flax.linen.Module):
    """Stands in for ``nn.Dropout`` (no parameters, so no name changes)."""

    rate: float = 0.0
    deterministic: bool = True

    def __call__(self, x):
        return x


@pytest.fixture
def no_draws(monkeypatch):
    """Augmentation and dropout off on both sides, BatchNorms still on the
    batch's statistics in training mode."""
    import voice100_tpu.models.asr_v1 as jax_asr_v1
    import voice100_tpu_torch.models.asr_v1 as port_asr_v1

    monkeypatch.setattr(jax_asr_v1, "batch_spectrogram_augment", lambda key, a, n: (a, n))
    monkeypatch.setattr(flax.linen, "Dropout", _Identity)
    monkeypatch.setattr(port_asr_v1, "apply_augment", lambda a, n, draws: (a, n))
    monkeypatch.setattr(port_asr_v1, "draw_augment", lambda *shape: None)

    def off(model):
        for module in model.modules():
            if isinstance(module, torch.nn.Dropout):
                module.p = 0.0
        return model

    return off


def _jax_pair(name, kwargs, inputs, seed=0):
    import voice100_tpu.models as J

    model = getattr(J, name)(**kwargs)
    variables = dict(jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in inputs))))
    if "world_norm" in variables:
        variables["world_norm"] = {"norm": {k: np.asarray(v, np.float32)
                                            for k, v in STATS.items()}}
    port = getattr(P, name)(**kwargs, device="cpu")
    port.load_state_dict(from_jax_variables(variables, model=name), strict=True)
    return model, variables, port


def _jax_trajectory(model, variables, batches, train, steps_per_epoch=1):
    """The JAX trainer's step (``trainer.py:161-177``) over ``batches``:
    ``task.loss`` under ``jax.grad``, the batch stats it mutates carried
    to the next step, ``optax.chain(clip_by_global_norm(1.0),
    task.make_optimizer(steps_per_epoch))``. Returns the losses, the
    rates, the first step's gradients and batch stats, and the last
    variables."""
    from voice100_tpu.training.tasks import make_task as jax_make_task

    task = jax_make_task(model)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0),
                            task.make_optimizer(steps_per_epoch))
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    opt_state = optimizer.init(params)
    losses, lrs, first = [], [], None
    for step, batch in enumerate(batches):
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

        def loss_fn(p):
            loss, _, new_extra = task.loss(p, extra, jbatch, jax.random.PRNGKey(step), train=train)
            return loss, new_extra

        (loss, extra), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        if first is None:
            first = {"params": grads, **extra}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        lrs.append(float(task.lr_schedule(step)))
    return losses, lrs, first, {"params": params, **extra}


def _port_steps(port, batches, train, steps_per_epoch=1):
    trainer = Trainer(TrainerConfig())
    task = make_task(port)
    state = TrainState(port, task.make_optimizer(steps_per_epoch))
    losses, lrs, first = [], [], None
    for batch in batches:
        batch = tuple(tuple(torch.from_numpy(np.array(a)) for a in group) for group in batch)
        losses.append(float(trainer.train_step(task, state, batch, train=train)["loss"]))
        lrs.append(state.optimizer.param_groups[0]["lr"])
        if first is None:
            first = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    return losses, lrs, first, state


def assert_trajectory_close(got, want, start, steps, atol, rtol=0.0, flat_grads=None):
    """Parameters after ``steps`` Adam steps (port state-dict names) against
    the reference's. BatchNorm makes some directions of the loss flat
    (:data:`FLAT`): their float32 gradients are round-off on both sides
    (``flat_grads``, where given, checks it), and Adam turns a round-off
    gradient into a step of up to ``lr``, so those tensors are held to
    Adam's reach (``FLAT_ATOL``) alone. Every other tensor: the 99th
    percentile of its differences within ``atol + rtol |want|``, at most
    1% of its elements (at least 2) beyond it (an element whose gradient
    is near zero steps by ``lr * sign(g)`` either way), none beyond
    ``FLAT_ATOL``; every tensor moved."""
    flat = [k for k in want if FLAT.search(k)]
    assert flat and got.keys() == want.keys()
    for key, w in want.items():
        if "running" in key or key.startswith("norm."):  # buffers, not parameters
            continue
        w, g = w.numpy(), got[key].numpy()
        err = np.abs(g - w)
        assert err.max() <= FLAT_ATOL * steps / 3, f"{key}: {err.max():.3e}"
        assert np.abs(w - start[key].numpy()).max() > 1e-6, key
        if key in flat:
            continue
        bound = atol + rtol * np.abs(w)
        assert np.quantile(err - bound, 0.99) <= 0, f"{key}: p99 beyond the bound"
        assert int((err > bound).sum()) <= max(2, int(0.01 * err.size)), \
            f"{key}: {int((err > bound).sum())} of {err.size} beyond the bound"
    if flat_grads is not None:
        scale = max(float(np.abs(g.numpy()).max()) for k, g in flat_grads.items()
                    if "running" not in k and not k.startswith("norm."))
        for key in flat:
            assert np.abs(flat_grads[key].numpy()).max() <= FLAT_GRAD * scale, key


def _assert_close_to_jax(name, port, want_vars, start_vars, first_grads=None, steps=3):
    want = from_jax_variables(want_vars, model=name)
    start = from_jax_variables(start_vars, model=name)
    grads = None if first_grads is None else from_jax_variables(first_grads, model=name)
    assert_trajectory_close(port.state_dict(), want, start, steps, PARAM_ATOL,
                            flat_grads=grads)


def _assert_stats_close(stats, first, name):
    """The running averages after the first step (of the same weights on
    both sides) against flax's mutated batch stats."""
    want = from_jax_variables(first, model=name)
    assert stats and stats.keys() <= want.keys()
    for key, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=key)


def test_asr_v1_three_steps_with_the_staircase_match_jax(no_draws):
    batches = _batches(3)
    model, variables, port = _jax_pair("AudioToTextCTC", ASR_ARGS, [batches[0][0][0]])
    want_losses, want_lrs, first, want_vars = _jax_trajectory(model, variables, batches, True, 2)
    losses, lrs, stats, state = _port_steps(no_draws(port), batches, True, 2)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert state.optimizer.param_groups[0]["weight_decay"] == 4e-5
    np.testing.assert_allclose(lrs, [1e-3, 1e-3, 0.98e-3], rtol=1e-12)
    np.testing.assert_allclose(lrs, want_lrs, rtol=1e-6)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_stats_close(stats, first, "AudioToTextCTC")
    _assert_close_to_jax("AudioToTextCTC", port, want_vars, variables, first)


def test_align_v1_three_steps_match_jax():
    batches = _batches(3)
    audio, audio_len = batches[0][0]
    model, variables, port = _jax_pair("AudioAlignCTC", ALIGN_ARGS, [audio, audio_len])
    want_losses, _, _, want_vars = _jax_trajectory(model, variables, batches, False)
    losses, lrs, _, state = _port_steps(port, batches, False)
    assert type(state.optimizer) is torch.optim.Adam and lrs == [1e-3] * 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = to_jax_variables(port.state_dict(), model="AudioAlignCTC")["params"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, want in jax.tree_util.tree_leaves_with_path(want_vars["params"]):
        np.testing.assert_allclose(flat_got[path], np.asarray(want), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def _world_batches(n, seed=3, rows=4, frames=32, tokens=16):
    """Collated WORLD batches drawn from ``STATS`` whose f0 stays within
    the decoder's ``2 L - 1`` frames of each row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        text_len = np.asarray([16, 11, 5, 9], np.int32)[:rows]
        f0_len = np.minimum(2 * text_len - 1, frames).astype(np.int32)
        valid = np.arange(frames)[None, :] < f0_len[:, None]

        def draw(stream, shape):
            return rng.normal(np.asarray(STATS[f"{stream}_mean"]),
                              np.asarray(STATS[f"{stream}_std"]), shape)

        f0 = np.where(rng.random((rows, frames)) < 0.3, 0.0, draw("f0", (rows, frames))) * valid
        logspc = draw("logspc", (rows, frames, 25)) * valid[:, :, None]
        codeap = draw("codeap", (rows, frames, 1)) * valid[:, :, None]
        text = rng.integers(1, VOCAB, (rows, tokens)).astype(np.int32)
        text[np.arange(tokens)[None, :] >= text_len[:, None]] = 0
        out.append(((f0.astype(np.float32), f0_len, logspc.astype(np.float32),
                     codeap.astype(np.float32)), (text, text_len)))
    return out


def test_tts_audio_v1_three_steps_match_jax():
    batches = _world_batches(3)
    model, variables, port = _jax_pair("AlignTextToAudioModel", TTS_ARGS, [batches[0][1][0]])
    want_losses, _, first, want_vars = _jax_trajectory(model, variables, batches, True)
    losses, _, stats, state = _port_steps(port, batches, True)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_stats_close(stats, first, "AlignTextToAudioModel")
    _assert_close_to_jax("AlignTextToAudioModel", port, want_vars, variables, first)
    # the task's metric names are the JAX package's
    metrics = make_task(port).loss(tuple(tuple(torch.from_numpy(a) for a in g)
                                         for g in batches[0]), train=False)[1]
    assert list(metrics) == ["loss", "hasf0_loss", "f0_loss", "logspc_loss", "codeap_loss"]


def test_collate_world_text_target_and_target_vocab_match_jax(tmp_path):
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.data import collate as jc
    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.data import collate as tc

    rng = np.random.default_rng(9)
    items = [((rng.normal(size=n).astype(np.float32), rng.normal(size=(n, 25)).astype(np.float32),
               rng.normal(size=(n, 1)).astype(np.float32)),
              rng.integers(1, 29, m).astype(np.int32), rng.integers(1, 71, g).astype(np.int32))
             for n, m, g in ((37, 9, 20), (70, 17, 3), (5, 1, 33))]
    for kwargs in ({}, {"time_bucket": 16, "text_bucket": 4}):
        got, want = tc.collate_world_text_target(items, **kwargs), \
            jc.collate_world_text_target(items, **kwargs)
        flat_got, flat_want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(flat_got) == len(flat_want) == 8
        for g, w in zip(flat_got, flat_want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert tc.collate_world_text_target.pad_values == jc.collate_world_text_target.pad_values
    assert tc.collate_world_text_target.var_specs == jc.collate_world_text_target.var_specs

    # the data modules: the port reads the WORLD cache the JAX module wrote
    root = str(tmp_path / "data")
    make_dummy_corpus(root, n_clips=4)
    kwargs = dict(vocoder="world_mcep", dataset="dummy_en", use_align=True, use_target=True,
                  data_dir=root, cache_dir=str(tmp_path / "cache"), batch_size=2)
    ref, port = JaxData(**kwargs), AudioTextDataModule(**kwargs, device="cpu")
    assert port.target_vocab_size == ref.target_vocab_size == 71
    assert port.vocab_size == ref.vocab_size
    ref.setup("predict")
    port.setup("predict")
    want = list(ref.predict_dataloader().iter_with_counts())
    got = list(port.predict_dataloader().iter_with_counts())
    assert [n for _, n in got] == [n for _, n in want]
    for (g, _), (w, _) in zip(got, want):
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)):
            assert a.dtype == b.dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()


# --- the train-v1 CLIs ------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1_train")
    make_dummy_corpus(str(root / "data"), n_clips=4)
    return root


def _common(workdir, name, cache="cache"):
    return ["--dataset", "dummy_en", "--data_dir", str(workdir / "data"), "--cache_dir",
            str(workdir / cache), "--batch_size", "2", "--max_epochs", "1", "--hidden_size", "8",
            "--checkpoint_dir", str(workdir / name), "--device", "cpu"]


def _saved(path):
    return torch.load(path, weights_only=True)


def test_train_asr_v1_cli_and_resume(workdir):
    from voice100_tpu_torch.tools.train_v1 import asr_cli_main

    asr_cli_main(_common(workdir, "asr") + ["--embed_size", "8"])
    last = workdir / "asr" / "last.pt"
    first = _saved(last)
    assert (first["epoch"], first["step"]) == (1, 2)
    assert {"encoder.layers.0.conv.0.1.running_mean", "decoder.layers.1.weight"} <= \
        set(first["model"])
    assert first["optimizer"]["param_groups"][0]["weight_decay"] == 4e-5
    # resume: the saved epoch, step and weights, then one more epoch
    asr_cli_main(_common(workdir, "asr") + ["--embed_size", "8", "--max_epochs", "2",
                                            "--resume_from_checkpoint", str(last)])
    again = _saved(last)
    assert (again["epoch"], again["step"]) == (2, 4)
    assert not torch.equal(again["model"]["decoder.layers.1.weight"],
                           first["model"]["decoder.layers.1.weight"])


def test_train_align_v1_cli_then_align_text(workdir):
    from voice100_tpu_torch.tools.align_text import cli_main as align_main
    from voice100_tpu_torch.tools.train_v1 import align_cli_main

    align_cli_main(_common(workdir, "align"))
    last = workdir / "align" / "last.pt"
    assert _saved(last)["step"] == 2
    # the align tool builds AudioAlignCTC through the same build_from_config
    config = workdir / "align_v1.yaml"
    config.write_text(
        "model:\n  class_path: voice100.models.AudioAlignCTC\n"
        "  init_args: {audio_size: 64, vocab_size: 29, hidden_size: 8}\n"
        "data:\n  class_path: voice100_tpu.data.AudioTextDataModule\n"
        "  init_args: {vocoder: mel, dataset: dummy_en, batch_size: 3}\n")
    out = workdir / "align-v1.txt"
    align_main(["--config", str(config), "--checkpoint", str(last), "--data_dir",
                str(workdir / "data"), "--cache_dir", str(workdir / "cache"), "--output", str(out),
                "--device", "cpu"])
    lines = [line.split("|") for line in out.read_text().splitlines()]
    assert len(lines) == 4
    for text, aligntext, counts in lines:
        counts = [int(c) for c in counts.split()]
        assert len(counts) == 2 * len(text) + 1 and sum(counts) == len(aligntext)


def test_train_ttsalign_v1_cli_and_predict(workdir):
    from voice100_tpu_torch.tools.train_v1 import ttsalign_cli_main
    from voice100_tpu_torch.training.cli import main

    ttsalign_cli_main(_common(workdir, "ttsalign"))
    last = workdir / "ttsalign" / "last.pt"
    assert _saved(last)["step"] == 2
    config = workdir / "ttsalign_v1.yaml"
    config.write_text(
        "model:\n  class_path: voice100_tpu.models.TextToAlignTextModel\n"
        "  init_args: {vocab_size: 29, hidden_size: 8}\n"
        "data:\n  class_path: voice100.data_modules.AlignTextDataModule\n"
        "  init_args: {dataset: dummy_en, batch_size: 3}\n")
    out = str(workdir / "ttsalign-pred")
    main(["predict", "--config", str(config), "--restore_from", str(last), "--data_dir",
          str(workdir / "data"), "--output", out, "--device", "cpu"])
    with np.load(out + ".npz", allow_pickle=True) as f:
        durations = f["durations"]
    texts = [line.split("|")[0] for line in
             (workdir / "data" / "dummy_en-align-train.txt").read_text().splitlines()]
    assert [d.shape for d in durations] == [(len(t), 2) for t in texts]


def test_train_ttsaudio_v1_cli_validate_and_predict(workdir):
    from voice100_tpu_torch.data.collate import bucket_extent
    from voice100_tpu_torch.tools.calc_stat import cli_main as stat_main
    from voice100_tpu_torch.tools.train_v1 import ttsaudio_cli_main
    from voice100_tpu_torch.training.cli import main

    stat_path = str(workdir / "data" / "dummy_en-stat.npz")
    stat_main(["--output", stat_path, "--dataset", "dummy_en", "--vocoder", "world",
               "--data_dir", str(workdir / "data"), "--cache_dir", str(workdir / "cache_w"),
               "--batch_size", "2", "--device", "cpu"])
    ttsaudio_cli_main(_common(workdir, "ttsaudio", "cache_w") + ["--vocoder", "world"])
    last = workdir / "ttsaudio" / "last.pt"
    saved = _saved(last)
    stats = dict(np.load(stat_path))
    # the statistics merged into the fresh weights (no resume)
    np.testing.assert_allclose(saved["model"]["norm.f0_mean"].numpy(), stats["f0_mean"],
                               rtol=1e-6)
    assert saved["model"]["norm.logspc_mean"].shape == (257,)
    config = workdir / "ttsaudio_v1.yaml"
    config.write_text(
        "model:\n  class_path: voice100.models.AlignTextToAudioModel\n"
        "  init_args: {vocab_size: 29, hidden_size: 8}\n"
        "data:\n  class_path: voice100_tpu.data.AudioTextDataModule\n"
        "  init_args: {vocoder: world, dataset: dummy_en, use_align: true, batch_size: 2,\n"
        "              valid_ratio: 0.5}\n")
    common = ["--config", str(config), "--restore_from", str(last), "--data_dir",
              str(workdir / "data"), "--cache_dir", str(workdir / "cache_w"), "--device", "cpu"]
    metrics = main(["validate", *common])
    assert set(metrics) == {"loss", "hasf0_loss", "f0_loss", "logspc_loss", "codeap_loss"}
    out = str(workdir / "ttsaudio-pred")
    main(["predict", *common, "--output", out])
    with np.load(out + ".npz", allow_pickle=True) as f:
        f0, logspc = f["f0"], f["logspc"]
    aligned = [line.split("|")[1] for line in
               (workdir / "data" / "dummy_en-align-train.txt").read_text().splitlines()]
    # 2 * aligntext_len frames a row, cut from the decoder's 2 T - 1 (T the
    # batch's padded text length)
    assert len(f0) == 4 and all(x.shape[1] == 257 for x in logspc)
    padded = [bucket_extent("text", max(len(a) for a in aligned[i:i + 2]))
              for i in range(0, 4, 2)]
    assert [len(x) for x in f0] == [min(2 * len(a), 2 * padded[i // 2] - 1)
                                    for i, a in enumerate(aligned)]


def test_train_ttsaudio_mt_v1_cli(workdir):
    from voice100_tpu_torch.tools.train_v1 import ttsaudio_mt_cli_main
    from voice100_tpu_torch.training.cli import main

    ttsaudio_mt_cli_main(_common(workdir, "ttsaudio_mt", "cache_w") + ["--vocoder", "world"])
    last = workdir / "ttsaudio_mt" / "last.pt"
    saved = _saved(last)
    assert saved["step"] == 2 and saved["model"]["decoder.layer3.weight"].shape == (71, 8, 1)
    config = workdir / "ttsaudio_mt_v1.yaml"
    config.write_text(
        "model:\n  class_path: voice100.models.AlignTextToAudioMultiTaskModel\n"
        "  init_args: {vocab_size: 29, target_vocab_size: 71, hidden_size: 8}\n"
        "data:\n  class_path: voice100_tpu.data.AudioTextDataModule\n"
        "  init_args: {vocoder: world, dataset: dummy_en, use_align: true, use_target: true,\n"
        "              batch_size: 2, valid_ratio: 0.5}\n")
    metrics = main(["validate", "--config", str(config), "--restore_from", str(last),
                    "--data_dir", str(workdir / "data"), "--cache_dir", str(workdir / "cache_w"),
                    "--device", "cpu"])
    assert list(metrics) == ["loss", "hasf0_loss", "f0_loss", "logspc_loss", "codeap_loss",
                             "phone_loss"]
    assert np.isfinite(metrics["loss"])


def test_predict_is_not_supported_for_the_v1_ctc_models(workdir):
    from voice100_tpu_torch.training.cli import main

    config = workdir / "asr_v1.yaml"
    config.write_text(
        "model:\n  class_path: voice100.models.AudioToTextCTC\n"
        "  init_args: {audio_size: 64, vocab_size: 29, embed_size: 8, hidden_size: 8}\n"
        "data:\n  class_path: voice100_tpu.data.AudioTextDataModule\n"
        "  init_args: {vocoder: mel, dataset: dummy_en, batch_size: 2}\n")
    asr_last = workdir / "asr" / "last.pt"
    if not asr_last.exists():
        from voice100_tpu_torch.tools.train_v1 import asr_cli_main

        asr_cli_main(_common(workdir, "asr") + ["--embed_size", "8"])
    with pytest.raises(SystemExit, match="predict is not supported for AudioToTextCTC"):
        main(["predict", "--config", str(config), "--restore_from", str(asr_last),
              "--data_dir", str(workdir / "data"), "--cache_dir", str(workdir / "cache"),
              "--output", str(workdir / "asr-pred"), "--device", "cpu"])


# --- the device cache and data parallelism ----------------------------------

def test_asr_v1_chunked_fit_equals_the_per_step_fit_bit_for_bit(tmp_path):
    from voice100_tpu_torch.data import AudioTextDataModule

    corpus = str(tmp_path / "data")
    make_dummy_corpus(corpus, n_clips=12)
    states, records = [], []
    for k in (1, 2):
        log = str(tmp_path / f"k{k}.jsonl")
        trainer = Trainer(TrainerConfig(max_epochs=3, device_cache=True, steps_per_dispatch=k,
                                        log_path=log, log_every_n_steps=1))
        model = P.AudioToTextCTC(**ASR_ARGS, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        data = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=corpus,
                                   cache_dir=str(tmp_path / "cache"), batch_size=4,
                                   valid_ratio=0.0, device="cpu")
        states.append(trainer.fit(model, data))
        trainer.close()
        records.append(_records(log))
    assert any(r.get("event") == "scan_dispatch" for r in records[1])
    assert states[0].step == states[1].step == 9
    base, chunked = states[0].model.state_dict(), states[1].model.state_dict()
    assert any("running_var" in name for name in base)
    for name in base:
        assert torch.equal(base[name], chunked[name]), name
    # the staircase at 3 steps an epoch: the epoch records' rates
    lrs = [[r["lr"] for r in rs if "train_time_s" in r] for rs in records]
    assert lrs[0] == lrs[1]
    np.testing.assert_allclose(lrs[0], [1e-3 * 0.98 ** e for e in (1, 2, 3)], rtol=1e-12)


def test_two_asr_v1_ranks_with_global_batchnorm_train_as_one_process(tmp_path):
    batches = _batches(3, seed=11)
    data = tmp_path / "asr_v1.pt"
    torch.save({"train": batches, "val": _batches(1, seed=12)}, data)
    common = {"mode": "fit", "model": "asr_v1", "model_args": ASR_ARGS, "batches": str(data)}

    # the data tells the global batch's BatchNorm statistics from the
    # ranks' own: training mode, augmentation and dropout off, the CTC
    # loss a mean over rows, so only the statistics tell the two apart
    model = worker.build_model(common).train()
    model.decoder.layers[0].p = 0.0
    task = make_task(model)
    with torch.no_grad():
        whole = float(model.compute_loss(*task.upload(worker._tensors(batches[0]))))
        halves = [float(model.compute_loss(*task.upload(
            worker._tensors(worker._rows(batches[0], r, 2))))) for r in range(2)]
    assert abs(np.mean(halves) - whole) > 100 * LOSS_RTOL * abs(whole)

    cfg = {"max_epochs": 2, "log_every_n_steps": 1, "monitor": "val_loss"}
    worker.run({**common, "config": {**cfg, "checkpoint_dir": str(tmp_path / "p1"),
                                     "log_path": str(tmp_path / "p1.jsonl")}})
    _worker_ranks(tmp_path, "asr_v1", lambda rank: {**common, "config": {
        **cfg, "checkpoint_dir": str(tmp_path / "p2"), "log_path": str(tmp_path / "p2.jsonl")}})
    got, want = _records(tmp_path / "p2.jsonl"), _records(tmp_path / "p1.jsonl")
    assert [r["step"] for r in got if "train_loss" in r] == [1, 2, 3, 3, 4, 5, 6, 6]
    _assert_same_run(got, want)
    start = worker.build_model(common).state_dict()
    for name in ("best.pt", "last.pt"):
        weights, want = _weights(tmp_path / "p2" / name), _weights(tmp_path / "p1" / name)
        assert_trajectory_close(weights, want, start, 6, W_ATOL, W_RTOL)
        for key in want:
            # the global statistics: one process's. A running mean behind a
            # flat shift (FLAT) carries that shift's round-off, ~1e-4
            if "running" in key:
                np.testing.assert_allclose(weights[key].numpy(), want[key].numpy(), rtol=1e-3,
                                           atol=1e-3, err_msg=key)


# --- bf16 -------------------------------------------------------------------

def _jax_cast(a):
    return a.astype(ml_dtypes.bfloat16) if getattr(a, "dtype", None) == np.float32 else a


def test_align_v1_three_bf16_steps_match_the_jax_trainer_step(monkeypatch):
    """``precision="16"`` reaches the biLSTM alone in both packages: the
    conv and dense layers stay float32, the biLSTM runs its bf16 kernels'
    twins (JAX: the Pallas kernels, ``VOICE100_TPU_LSTM_KERNEL=pallas``),
    the audio uploads as bf16 (the pair layout's input)."""
    from voice100_tpu.ops.lstm import set_default_compute_dtype as jax_set_dtype
    from voice100_tpu.training.tasks import make_task as jax_make_task

    monkeypatch.delenv("VOICE100_TPU_MATMUL_DTYPE", raising=False)
    monkeypatch.setenv("VOICE100_TPU_LSTM_KERNEL", "pallas")
    batches = _batches(3, seed=21)
    audio, audio_len = batches[0][0]
    model, variables, port = _jax_pair("AudioAlignCTC", ALIGN_ARGS, [audio, audio_len], seed=2)
    task = jax_make_task(model)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    params, opt_state, want_losses = variables["params"], None, []
    opt_state = optimizer.init(params)
    jax_set_dtype(jnp.bfloat16)
    try:
        for batch in batches:
            jbatch = jax.tree_util.tree_map(jnp.asarray, task.upload_cast(batch, _jax_cast))
            loss, grads = jax.value_and_grad(
                lambda p: task.loss(p, {}, jbatch, None, train=False)[0])(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            want_losses.append(float(loss))
    finally:
        jax_set_dtype(None)
    try:
        trainer = Trainer(TrainerConfig(precision="16"))
        trainer.apply_precision()
        port_task = make_task(port)
        state = TrainState(port, port_task.make_optimizer())
        losses = []
        for batch in batches:
            batch = tuple(tuple(torch.from_numpy(np.array(a)) for a in g) for g in batch)
            batch = port_task.upload_cast(batch, _to_bf16)
            assert batch[0][0].dtype == torch.bfloat16 and batch[1][0].dtype == torch.int32
            losses.append(float(trainer.train_step(port_task, state, batch, train=False)["loss"]))
    finally:
        set_default_compute_dtype(None)
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, want_losses, rtol=BF16_LOSS_RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_variables(port.state_dict(), model="AudioAlignCTC")["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(params):
        name = jax.tree_util.keystr(path)
        err = np.abs(np.asarray(got[path]) - np.asarray(want))
        assert np.quantile(err, 0.99) <= PARAM_P99, f"{name}: p99 {np.quantile(err, 0.99):.3e}"
        assert int((err > BF16_PARAM_ATOL).sum()) <= max(2, int(FLIPS * err.size)), name
        assert err.max() <= FLIP_ATOL, f"{name}: {err.max():.3e}"
