"""The port's training CLI vs the JAX package's (CPU).

* ``ops/metrics.py``: ``levenshtein`` and ``error_rate`` equal the JAX
  package's on seeded random strings and word lists, empty references
  and hypotheses included;
* the trainer config from each ``config/asr_*.yaml``, with and without
  the ``--max_epochs``/``--batch_size`` overrides, equals the JAX
  ``build_from_config``'s on every field both have; the TTS configs build
  the JAX CLI's model and data classes at its sizes; settings the port
  does not run raise and say what is missing;
* ``validate``, ``test`` and ``predict`` from the same weights: JAX
  variables from ``make_task(model).init(PRNGKey(0), batch)``, saved as a
  JAX checkpoint and, through ``from_jax_variables``, as a port one. The
  JAX CLI (``--platform cpu``) and the port's (``--device cpu``) run on
  the same corpus and the same feature cache (the JAX run writes it, the
  port reads it: the mel path is held in test_torch_data.py). They print
  the same keys; ``run_eval``'s loss agrees within 1e-4 relative (float32
  sums in another order), CER and WER are equal, and the predict files
  are equal line for line;
* without CUDA the CLI raises unless ``--device cpu`` is passed.
"""

import os

import numpy as np
import pytest
import yaml

import jax
import torch

from corpus_fixture import make_dummy_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "config")) if f.endswith(".yaml"))
ASR_CONFIGS = [f for f in CONFIGS if f.startswith("asr_")]
SETTINGS = ((32, False, 3, 2, 1, False), (32, False, 3, 1, 1, False))
HIDDEN = 32


def tiny_config(path, **trainer):
    """The narrow ASR config (two conv blocks of 32, one biLSTM layer of
    H=32) on the dummy_en corpus, batch 4, a quarter of the clips held
    out for validation."""
    config = {
        "seed_everything": 1234,
        "trainer": {"max_epochs": 1, "gradient_clip_val": 1.0, **trainer},
        "model": {"class_path": "voice100_tpu.models.AudioToAlignText",
                  "init_args": {"vocab_size": 29, "audio_size": 64,
                                "encoder_settings": [list(s) for s in SETTINGS],
                                "decoder_num_layers": 1, "decoder_hidden_size": HIDDEN,
                                "learning_rate": 0.001}},
        "data": {"class_path": "voice100_tpu.data.AudioTextDataModule",
                 "init_args": {"vocoder": "mel", "dataset": "dummy_en", "language": "en",
                               "batch_size": 4, "valid_ratio": 0.25}},
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


# --- ops/metrics.py -------------------------------------------------------

def _random_pairs(seed, words):
    rng = np.random.default_rng(seed)
    alphabet = list("abcde ") if not words else ["the", "a", "fox", "dog", "jumps"]
    pairs = [([], []), (["x"] if words else "x", []), ([], ["y"] if words else "y")]
    for _ in range(20):
        ref = list(rng.choice(alphabet, size=int(rng.integers(0, 12))))
        hyp = list(rng.choice(alphabet, size=int(rng.integers(0, 12))))
        pairs.append((ref, hyp) if words else ("".join(ref), "".join(hyp)))
    return pairs


@pytest.mark.parametrize("words", [False, True], ids=["chars", "words"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed, words):
    from voice100_tpu.ops import metrics as jax_metrics
    from voice100_tpu_torch.ops import metrics

    pairs = _random_pairs(seed, words)
    for ref, hyp in pairs:
        assert metrics.levenshtein(ref, hyp) == jax_metrics.levenshtein(ref, hyp)
    refs, hyps = [p[0] for p in pairs], [p[1] for p in pairs]
    assert metrics.error_rate(refs, hyps) == jax_metrics.error_rate(refs, hyps)
    assert metrics.error_rate([], []) == jax_metrics.error_rate([], []) == (0, 0)


# --- the trainer config -----------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, {"max_epochs": 3, "batch_size": 16}],
                         ids=["config", "overrides"])
@pytest.mark.parametrize("name", ASR_CONFIGS)
def test_trainer_config_matches_jax(name, overrides):
    import dataclasses

    from voice100_tpu.training.cli import build_from_config as jax_build
    from voice100_tpu_torch.training.cli import (UNPORTED, build_from_config,
                                                 build_trainer_config, load_config)

    config = load_config(os.path.join(ROOT, "config", name))
    overrides = {**overrides, "checkpoint_dir": "ck", "log_path": "log.jsonl"}
    _, jax_data, want, _ = jax_build(config, overrides)
    got = build_trainer_config(config, overrides)
    ours = {f.name for f in dataclasses.fields(got)}
    theirs = {f.name for f in dataclasses.fields(want)}
    # every JAX setting is a field here or one the port refuses past its default
    assert ours < theirs and theirs - ours == set(UNPORTED)
    assert {k: getattr(got, k) for k in ours} == {k: getattr(want, k) for k in ours}
    assert all(getattr(want, k) in UNPORTED[k][0] for k in theirs - ours)
    _, data = build_from_config(config, overrides, device="cpu")
    assert (data.batch_size, data.vocab_size) == (jax_data.batch_size, jax_data.vocab_size)


@pytest.mark.parametrize("name", [f for f in CONFIGS if not f.startswith("asr_")])
def test_configs_the_port_cannot_build_raise_naming_the_class(name):
    """The TTS configs, which raised until their training was ported, now
    build: the model and data module of the JAX build_from_config's
    classes and sizes, the statistics file the config names."""
    from voice100_tpu.training.cli import build_from_config as jax_build
    from voice100_tpu_torch.training.cli import build_from_config, config_audio_stat, load_config

    config = load_config(os.path.join(ROOT, "config", name))
    want_model, want_data, _, want_stat = jax_build(config, {})
    model, data = build_from_config(config, {}, device="cpu")
    assert type(model).__name__ == type(want_model).__name__
    assert type(data).__name__ == type(want_data).__name__
    assert (model.vocab_size, data.vocab_size) == (want_model.vocab_size, want_data.vocab_size)
    assert getattr(model, "audio_size", None) == getattr(want_model, "audio_size", None)
    assert getattr(data, "audio_size", None) == getattr(want_data, "audio_size", None)
    assert data.batch_size == want_data.batch_size == 128
    assert config_audio_stat(config) == want_stat
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("key,value,item", [
    ("mesh_model_axis", 2, "item 10"), ("profile_dir", "prof", "item 10"),
    ("upload_dtype", "bfloat16", "item 5"), ("device_cache", True, "item 8"),
    ("device_cache_max_bytes", 1024, "item 8"), ("steps_per_dispatch", 4, "item 8"),
])
def test_unported_trainer_settings_raise_naming_their_item(tmp_path, key, value, item):
    from voice100_tpu_torch.training.cli import cli_main

    cfg = tiny_config(tmp_path / "tiny.yaml", **{key: value})
    with pytest.raises(NotImplementedError, match=f"{key}.*ROADMAP.md queue 1, {item}"):
        cli_main(["fit", "--config", cfg, "--device", "cpu"])


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh_model_axis", "2"], NotImplementedError, "mesh_model_axis.*item 10"),
    (["--distributed"], NotImplementedError, "distributed.*item 10"),
    (["--precision", "16"], ValueError, "bf16.*item 5"),
])
def test_unported_flags_raise(tmp_path, flags, error, match):
    from voice100_tpu_torch.training.cli import cli_main

    cfg = tiny_config(tmp_path / "tiny.yaml")
    with pytest.raises(error, match=match):
        cli_main(["validate", "--config", cfg, "--device", "cpu"] + flags)


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from voice100_tpu_torch.training.cli import cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(tmp_path / "tiny.yaml")
    for sub in ("fit", "validate", "predict"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main([sub, "--config", cfg, "--data_dir", str(tmp_path / "none"),
                      "--checkpoint_dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


# --- validate / test / predict against the JAX CLI ---------------------------

@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """A corpus, the tiny config, and the same initial weights as a JAX
    checkpoint and a port checkpoint."""
    import optax
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.models import AudioToAlignText as JaxModel
    from voice100_tpu.training import TrainState as JaxState, make_task as jax_make_task
    from voice100_tpu.training.checkpoint import save_checkpoint as jax_save
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.tools.weights import from_jax_variables
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    root = tmp_path_factory.mktemp("cli_parity")
    data_dir = str(root / "data")
    make_dummy_corpus(data_dir, n_clips=8)
    cfg = tiny_config(root / "tiny.yaml")
    jax_model = JaxModel(audio_size=64, vocab_size=29, encoder_settings=SETTINGS,
                         decoder_num_layers=1, decoder_hidden_size=HIDDEN)
    data = JaxData(vocoder="mel", dataset="dummy_en", data_dir=data_dir,
                   cache_dir=str(root / "cache"), batch_size=4, valid_ratio=0.25)
    data.setup("fit")
    variables = dict(jax_make_task(jax_model).init(jax.random.PRNGKey(0),
                                                   next(iter(data.train_dataloader()))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = variables.pop("params")
    jax_ckpt = str(root / "jax_ckpt")
    jax_save(jax_ckpt, JaxState(params=params, extra=variables,
                                opt_state=optax.adam(1e-3).init(params)))
    model = AudioToAlignText(64, 29, SETTINGS, 1, HIDDEN, device="cpu")
    model.load_state_dict(from_jax_variables({"params": params}), strict=True)
    port_ckpt = str(root / "port.pt")
    save_checkpoint(port_ckpt, TrainState(model, torch.optim.Adam(model.parameters())))
    common = ["--config", cfg, "--data_dir", data_dir, "--cache_dir", str(root / "cache"),
              "--checkpoint_dir", str(root / "unused")]
    return {"root": root, "common": common, "jax_ckpt": jax_ckpt, "port_ckpt": port_ckpt,
            "jax_model": jax_model, "params": params, "data_dir": data_dir, "cfg": cfg}


def _printed_metrics(out, prefix):
    line = [ln for ln in out.splitlines() if ln.startswith(prefix + "_")][-1]
    return dict(kv.split("=") for kv in line.split())


@pytest.mark.parametrize("sub", ["validate", "test"])
def test_validate_and_test_match_the_jax_cli(parity, sub, capsys):
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.training import Trainer as JaxTrainer, TrainerConfig as JaxConfig
    from voice100_tpu.training import TrainState as JaxState
    from voice100_tpu.training.cli import cli_main as jax_cli
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState
    from voice100_tpu_torch.training.cli import build_from_config, cli_main, load_config
    from voice100_tpu_torch.training.checkpoint import load_model_weights

    prefix = "test" if sub == "test" else "val"
    jax_cli([sub, *parity["common"], "--restore_from", parity["jax_ckpt"], "--platform", "cpu"])
    want = _printed_metrics(capsys.readouterr().out, prefix)
    cli_main([sub, *parity["common"], "--restore_from", parity["port_ckpt"], "--device", "cpu"])
    got = _printed_metrics(capsys.readouterr().out, prefix)
    assert list(got) == list(want) == [f"{prefix}_{k}" for k in ("loss", "cer", "wer")]

    stage = "test" if sub == "test" else "fit"
    data = JaxData(vocoder="mel", dataset="dummy_en", data_dir=parity["data_dir"],
                   cache_dir=str(parity["root"] / "cache"), batch_size=4, valid_ratio=0.25)
    trainer = JaxTrainer(JaxConfig())
    state = JaxState(params=parity["params"], extra={}, opt_state=None)
    jax_metrics = trainer.run_eval(parity["jax_model"], data, state, stage)
    loader = data.test_dataloader() if stage == "test" else data.val_dataloader()
    jax_metrics.update(trainer._val_cer(parity["jax_model"], data, state, loader))

    model, port_data = build_from_config(load_config(parity["cfg"]), {
        "data_dir": parity["data_dir"], "cache_dir": str(parity["root"] / "cache")}, device="cpu")
    load_model_weights(parity["port_ckpt"], model)
    metrics = Trainer(TrainerConfig()).run_eval(model, port_data, TrainState(model, None), stage)
    assert metrics.keys() == jax_metrics.keys()
    np.testing.assert_allclose(metrics["loss"], jax_metrics["loss"], rtol=1e-4)
    assert (metrics["cer"], metrics["wer"]) == (jax_metrics["cer"], jax_metrics["wer"])
    assert 0.0 < metrics["cer"] <= 2.0


def test_predict_matches_the_jax_cli(parity):
    from voice100_tpu.training.cli import cli_main as jax_cli
    from voice100_tpu_torch.training.cli import cli_main

    root = parity["root"]
    jax_cli(["predict", *parity["common"], "--restore_from", parity["jax_ckpt"],
             "--platform", "cpu", "--output", str(root / "jax_hyps")])
    cli_main(["predict", *parity["common"], "--restore_from", parity["port_ckpt"],
              "--device", "cpu", "--output", str(root / "port_hyps")])
    want = (root / "jax_hyps.txt").read_text().splitlines()
    got = (root / "port_hyps.txt").read_text().splitlines()
    assert len(want) == 8 and any(want)
    assert got == want


def test_checkpoint_lookup_prefers_best_then_last(parity, tmp_path, capsys):
    """Without ``--restore_from`` the CLI reads ``<checkpoint_dir>/best.pt``,
    else ``last.pt``, and stops when neither is there; a ``--restore_from``
    that is not there raises, whatever the directory holds."""
    import shutil

    from voice100_tpu_torch.training.cli import cli_main

    common = parity["common"][:-2] + ["--checkpoint_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli_main(["validate", *common])
    shutil.copy(parity["port_ckpt"], tmp_path / "last.pt")
    cli_main(["validate", *common])
    from_last = _printed_metrics(capsys.readouterr().out, "val")
    cli_main(["validate", *common, "--restore_from", parity["port_ckpt"]])
    assert _printed_metrics(capsys.readouterr().out, "val") == from_last
    with pytest.raises(FileNotFoundError):
        cli_main(["validate", *common, "--restore_from", str(tmp_path / "missing.pt")])
    (tmp_path / "best.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        cli_main(["validate", *common])
