"""Port align slice vs the JAX package (CPU).

A narrow AudioToAlignText (the config of tests/test_tools.py:47-71: one
conv block of 16 channels, a 1-layer biLSTM with H=16) is initialised in
JAX and carried across with ``from_jax_variables``.

* ``ctc_best_path``: paths and labels equal to JAX's, scores within 1e-4
  (float32 logits differ by ~1e-7 from summation order; the Viterbi adds
  ~40 of them);
* ``run_align`` over a ``make_dummy_corpus`` corpus: the port reads the
  feature cache the JAX run wrote (same names and format), and the two
  output files are identical;
* the ``python -m voice100_tpu_torch.tools.align_text --device cpu`` CLI
  end to end, with the checks of tests/test_tools.py:97-104;
* ``build_from_config`` and the port's checkpoints.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from corpus_fixture import make_dummy_corpus
from voice100_tpu_torch.models import AudioToAlignText, TextToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables

SETTINGS = ((16, False, 3, 2, 1, False),)
VOCAB, MELS, HIDDEN = 29, 64, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model = JaxModel(audio_size=MELS, vocab_size=VOCAB, encoder_settings=SETTINGS,
                     decoder_num_layers=1, decoder_hidden_size=HIDDEN)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 21, MELS)), jnp.asarray([21]))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("align")
    make_dummy_corpus(str(root / "data"), n_clips=7)
    return root


def _port_model(variables):
    model = AudioToAlignText(MELS, VOCAB, SETTINGS, 1, HIDDEN, device="cpu").eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _config(path, data_dir):
    with open(path, "w") as f:
        yaml.safe_dump({
            "seed_everything": 1234,
            "model": {"class_path": "voice100.models.AudioToAlignText",
                      "init_args": {"vocab_size": VOCAB, "audio_size": MELS,
                                    "encoder_settings": [list(s) for s in SETTINGS],
                                    "decoder_num_layers": 1, "decoder_hidden_size": HIDDEN,
                                    "learning_rate": 0.001}},
            "data": {"class_path": "voice100_tpu.data.AudioTextDataModule",
                     "init_args": {"vocoder": "mel", "dataset": "dummy_en", "language": "en",
                                   "batch_size": 3, "data_dir": data_dir}},
        }, f)


def test_ctc_best_path_matches_jax(jax_model):
    """Ragged audio, and a text longer than its logits (capped, as
    asr_v2.py:85 caps it), through both models' ctc_best_path."""
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model, variables = jax_model
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((3, 57, MELS)).astype(np.float32)
    audio_len = np.asarray([57, 40, 13], np.int32)
    text = rng.integers(1, VOCAB, size=(3, 12)).astype(np.int32)
    text_len = np.asarray([12, 9, 12], np.int32)
    ref, ref_len = model.apply(variables, *(jnp.asarray(a) for a in (audio, audio_len, text,
                                                                     text_len)),
                               method=JaxModel.ctc_best_path)
    got, got_len = _port_model(variables).ctc_best_path(
        *(torch.from_numpy(a) for a in (audio, audio_len, text, text_len)))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert int(got_len[2]) < int(text_len[2])
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=1e-4)


def test_run_align_reads_the_jax_cache_and_writes_the_same_file(jax_model, workdir):
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.tools.align_text import run_align as jax_run_align
    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.tools.align_text import run_align

    model, variables = jax_model
    kwargs = dict(vocoder="mel", dataset="dummy_en", data_dir=str(workdir / "data"),
                  cache_dir=str(workdir / "cache"), batch_size=3)
    jax_data = JaxData(**kwargs)
    jax_data.setup("predict")
    assert jax_run_align(model, variables, jax_data, str(workdir / "jax.txt")) == 7
    cached = sorted(os.listdir(workdir / "cache"))
    data = AudioTextDataModule(**kwargs, device="cpu")
    assert data.cache_salt == jax_data.cache_salt == b"mel@float16"
    data.setup("predict")
    assert run_align(_port_model(variables), data, str(workdir / "port.txt"), device="cpu") == 7
    assert sorted(os.listdir(workdir / "cache")) == cached       # every feature from the cache
    want = (workdir / "jax.txt").read_text()
    assert (workdir / "port.txt").read_text() == want
    assert len(want.splitlines()) == 7


def test_align_cli_end_to_end_on_cpu(jax_model, workdir, tmp_path):
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    model = _port_model(jax_model[1])
    ckpt = str(tmp_path / "asr.pt")
    save_checkpoint(ckpt, TrainState(model, torch.optim.Adam(model.parameters())))
    cfg = str(tmp_path / "asr.yaml")
    data_dir = str(workdir / "data")
    _config(cfg, data_dir)
    out = str(tmp_path / "dummy_en-align-train.txt")
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "voice100_tpu_torch.tools.align_text", "--config", cfg,
         "--checkpoint", ckpt, "--data_dir", data_dir, "--cache_dir", str(tmp_path / "cache"),
         "--output", out, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 7 lines" in proc.stdout
    lines = open(out).read().strip().split("\n")
    assert len(lines) == 7
    for ln in lines:
        text, aligntext, counts = ln.split("|")
        counts = [int(c) for c in counts.split()]
        assert len(counts) == 2 * len(text) + 1
        assert sum(counts) == len(aligntext) > 0


def test_build_from_config_maps_class_paths_and_checks_sizes(tmp_path):
    from voice100_tpu_torch.training.cli import build_from_config, load_config

    cfg = str(tmp_path / "asr.yaml")
    _config(cfg, str(tmp_path / "data"))
    config = load_config(cfg)
    model, data = build_from_config(config, {"batch_size": 5, "cache_dir": "c", "max_epochs": 3},
                                    device="cpu")
    assert isinstance(model, AudioToAlignText) and model.encoder_settings == SETTINGS
    assert (data.batch_size, data.cache_dir, data.vocab_size) == (5, "c", VOCAB)
    assert next(model.parameters()).device.type == "cpu"
    config["model"]["init_args"]["vocab_size"] = 71
    with pytest.raises(SystemExit, match="vocab_size"):
        build_from_config(config, {}, device="cpu")
    config["model"]["class_path"] = "voice100_tpu.models.AudioToMel"
    with pytest.raises(ValueError, match="not ported"):
        build_from_config(config, {}, device="cpu")
    # a TTS model builds too (its vocabulary checked, audio_size not: the
    # TTS model's is its output width)
    config["model"]["class_path"] = "voice100_tpu.models.TextToAlignText"
    config["model"]["init_args"] = {"vocab_size": VOCAB, "num_layers": 1, "hidden_size": 32}
    model, _ = build_from_config(config, {}, device="cpu")
    assert isinstance(model, TextToAlignText) and model.vocab_size == VOCAB


def test_load_model_weights_reads_a_port_checkpoint(jax_model, tmp_path):
    from voice100_tpu_torch.training import TrainState, load_model_weights, save_checkpoint

    model = _port_model(jax_model[1])
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, TrainState(model, torch.optim.Adam(model.parameters()), step=3))
    fresh = AudioToAlignText(MELS, VOCAB, SETTINGS, 1, HIDDEN, device="cpu")
    assert load_model_weights(path, fresh) is fresh
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
