"""``fit`` of the port on a data module, through its CLI (CPU).

The narrow config of test_torch_cli.py on an 8-clip dummy_en corpus
(6 train clips, batch 4: two steps an epoch; 2 val clips):

* ``fit`` for 2 epochs writes ``best.pt``, ``last.pt`` and ``epoch_2.pt``;
  its records have the keys of the JAX CLI's ``fit`` records at the same
  config (``fit_start`` names the device in place of ``devices`` and
  ``processes``); ``--restore_from last.pt --max_epochs 3`` resumes at
  epoch 2 for one more epoch; ``validate`` on ``last.pt`` gives the last
  epoch's ``val_loss`` within 1e-6 relative, which holds the biLSTM's
  cached stacked weights to the weights Adam and ``load_state_dict``
  wrote in place;
* a stop (``request_stop`` armed before ``fit``, or SIGTERM) ends the fit
  after the current step, logs ``stopped``, saves ``last.pt``, leaves no
  loader thread behind, and a resume continues from it
  (tests/test_training.py:479 for the JAX trainer);
* the loader's prefetch thread gives the batches ``iter_with_counts``
  gives, epoch by epoch; ``bucket_by_length`` batches by time bucket once
  the feature cache is warm, and ``fit`` trains on the loader's batches.
"""

import json
import signal
import threading

import numpy as np
import pytest

import torch

from corpus_fixture import make_dummy_corpus
from test_torch_cli import tiny_config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("fit_data"))
    make_dummy_corpus(data_dir, n_clips=8)
    return data_dir


def _common(corpus, tmp_path, cfg):
    return ["--config", cfg, "--data_dir", corpus, "--cache_dir", str(tmp_path / "cache"),
            "--checkpoint_dir", str(tmp_path / "ckpt")]


def _records(path):
    return [json.loads(line) for line in open(path)]


def _prefetch_threads():
    from voice100_tpu_torch.data.loader import PREFETCH_THREAD

    return [t for t in threading.enumerate() if t.name == PREFETCH_THREAD and t.is_alive()]


def _data(corpus, tmp_path, **kwargs):
    from voice100_tpu_torch.data import AudioTextDataModule

    args = dict(vocoder="mel", dataset="dummy_en", data_dir=corpus,
                cache_dir=str(tmp_path / "cache"), batch_size=4, valid_ratio=0.25, device="cpu")
    return AudioTextDataModule(**{**args, **kwargs})


def _model():
    from test_torch_cli import HIDDEN, SETTINGS
    from voice100_tpu_torch.models import AudioToAlignText

    return AudioToAlignText(64, 29, SETTINGS, 1, HIDDEN, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def test_fit_through_the_cli_checkpoints_resumes_and_validates(corpus, tmp_path, capsys):
    from voice100_tpu.training.cli import cli_main as jax_cli
    from voice100_tpu_torch.training.cli import cli_main

    cfg = tiny_config(tmp_path / "tiny.yaml", log_every_n_steps=1, callbacks=[
        {"class_path": "voice100_tpu.training.ModelCheckpoint",
         "init_args": {"monitor": "val_loss", "every_n_epochs": 2}}])
    common = _common(corpus, tmp_path, cfg)
    log = str(tmp_path / "log.jsonl")
    cli_main(["fit", *common, "--max_epochs", "2", "--log_path", log, "--device", "cpu"])
    ckpt = tmp_path / "ckpt"
    for name in ("best.pt", "last.pt", "epoch_2.pt"):
        assert (ckpt / name).exists(), name
    assert not (ckpt / "epoch_1.pt").exists()
    records = _records(log)
    assert _prefetch_threads() == []
    start = records[0]
    assert (start["event"], start["steps_per_epoch"], start["device"]) == ("fit_start", 2, "cpu")
    epochs = [r for r in records if "train_time_s" in r]
    steps = [r for r in records if "train_loss" in r and "train_time_s" not in r]
    assert [(r["epoch"], r["step"]) for r in epochs] == [(0, 2), (1, 4)]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    for r in epochs:
        assert all(np.isfinite(r[k]) for k in ("train_loss", "val_loss", "val_cer", "val_wer"))

    # the JAX CLI's fit records at the same config, one epoch
    jax_log = str(tmp_path / "jax_log.jsonl")
    jax_cli(["fit", "--config", cfg, "--data_dir", corpus, "--cache_dir",
             str(tmp_path / "jax_cache"), "--checkpoint_dir", str(tmp_path / "jax_ckpt"),
             "--max_epochs", "1", "--log_path", jax_log, "--platform", "cpu"])
    jax_records = _records(jax_log)
    jax_start = next(r for r in jax_records if r.get("event") == "fit_start")
    assert start.keys() == (jax_start.keys() - {"devices", "processes", "upload"}) | {"device"}
    assert (start["params"], start["steps_per_epoch"]) == (jax_start["params"],
                                                          jax_start["steps_per_epoch"])
    jax_epoch = next(r for r in jax_records if "train_time_s" in r)
    jax_step = next(r for r in jax_records if "train_loss" in r and "train_time_s" not in r)
    assert all(r.keys() == jax_epoch.keys() for r in epochs)
    assert all(r.keys() == jax_step.keys() for r in steps)

    capsys.readouterr()
    cli_main(["validate", *common, "--restore_from", str(ckpt / "last.pt"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("val_loss=")
    from voice100_tpu_torch.training.cli import main

    metrics = main(["validate", *common, "--restore_from", str(ckpt / "last.pt"),
                    "--device", "cpu"])
    np.testing.assert_allclose(metrics["loss"], epochs[-1]["val_loss"], rtol=1e-6)
    assert (metrics["cer"], metrics["wer"]) == (epochs[-1]["val_cer"], epochs[-1]["val_wer"])

    cli_main(["fit", *common, "--max_epochs", "3", "--restore_from", str(ckpt / "last.pt"),
              "--log_path", log, "--device", "cpu"])
    resumed = [r for r in _records(log)[len(records):] if "train_time_s" in r]
    assert [(r["epoch"], r["step"]) for r in resumed] == [(2, 6)]
    saved = torch.load(ckpt / "last.pt", weights_only=True)
    assert (saved["epoch"], saved["step"]) == (3, 6)


def test_request_stop_saves_last_and_resumes(corpus, tmp_path):
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    ckpt = tmp_path / "ckpt"
    log = str(tmp_path / "log.jsonl")
    trainer = Trainer(TrainerConfig(max_epochs=50, checkpoint_dir=str(ckpt),
                                    monitor="train_loss", log_path=log))
    trainer.request_stop()  # armed before fit: stops after the first step
    state = trainer.fit(_model(), _data(corpus, tmp_path))
    trainer.close()
    assert (state.step, state.epoch) == (1, 0)
    assert (ckpt / "last.pt").exists() and not (ckpt / "best.pt").exists()
    stopped = [r for r in _records(log) if r.get("event") == "stopped"]
    assert stopped == [{"event": "stopped", "epoch": 0, "step": 1}]
    assert _prefetch_threads() == []
    assert not trainer._stop_requested  # a reused trainer runs its next fit

    resumed = Trainer(TrainerConfig(max_epochs=2, checkpoint_dir=str(ckpt),
                                    monitor="train_loss")).fit(
        _model(), _data(corpus, tmp_path), restore_from=str(ckpt / "last.pt"))
    # the stopped epoch runs again from its start, then one more
    assert (resumed.step, resumed.epoch) == (1 + 2 * 2, 2)


def test_sigterm_stops_after_the_step_and_a_second_signal_interrupts(corpus, tmp_path):
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed from the main thread only")
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(TrainerConfig(max_epochs=5, checkpoint_dir=str(tmp_path / "ckpt")))
    seen, train_step = [], trainer.train_step

    def step_then_signal(*args, **kwargs):
        out = train_step(*args, **kwargs)
        handler = signal.getsignal(signal.SIGTERM)
        seen.append(handler is not before)
        if len(seen) == 2:
            handler(signal.SIGTERM, None)
        return out

    trainer.train_step = step_then_signal
    state = trainer.fit(_model(), _data(corpus, tmp_path))
    assert state.step == 2 and seen == [True, True]
    assert (tmp_path / "ckpt" / "last.pt").exists()
    assert signal.getsignal(signal.SIGTERM) is before
    assert _prefetch_threads() == []

    def step_then_two_signals(*args, **kwargs):
        out = train_step(*args, **kwargs)
        handler = signal.getsignal(signal.SIGINT)
        handler(signal.SIGINT, None)
        handler(signal.SIGINT, None)
        return out

    trainer.train_step = step_then_two_signals
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(_model(), _data(corpus, tmp_path))
    assert signal.getsignal(signal.SIGTERM) is before
    assert _prefetch_threads() == []


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_prefetch_thread_gives_the_batches_iter_with_counts_gives(corpus, tmp_path, shuffle):
    data = _data(corpus, tmp_path, valid_ratio=0.0)
    data.setup("fit")
    loader = data._loader(data.train_ds, shuffle=shuffle)
    assert len(loader) == 2 and loader.prefetch > 0
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        threaded = list(loader)
        counted = list(loader.iter_with_counts())
        assert [n for _, n in counted] == [4, 4]
        assert len(threaded) == len(counted)
        for a, (b, _) in zip(threaded, counted):
            for x, y in zip(a[0] + a[1], b[0] + b[1]):
                np.testing.assert_array_equal(x, y)
    assert _prefetch_threads() == []


def _batch_keys(batches):
    return [np.asarray(b[0][0]).tobytes() for b in batches]


def test_fit_trains_on_length_buckets(corpus, tmp_path, monkeypatch):
    """With ``bucket_by_length`` and a warm feature cache, the train
    loader batches within collate time buckets, and ``fit`` trains on
    exactly the batches it gives after ``set_epoch``."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    monkeypatch.setenv("VOICE100_TPU_TIME_BUCKET", "32")
    data = _data(corpus, tmp_path, valid_ratio=0.0, bucket_by_length=True, batch_size=2)
    data.setup("fit")
    loader = data.train_dataloader()
    assert loader.length_hint is not None
    assert loader._bucketed_chunks(np.arange(8), None) is None  # cold: no lengths yet
    list(loader.iter_with_counts())  # warms the cache
    chunks = loader._bucketed_chunks(np.arange(8), None)
    assert chunks is not None and len(chunks) == 4
    trainer = Trainer(TrainerConfig(max_epochs=2, log_every_n_steps=100))
    seen, train_step = [], trainer.train_step

    def recording_step(task, state, batch, *args, **kwargs):
        seen.append(np.asarray(batch[0][0]).tobytes())
        return train_step(task, state, batch, *args, **kwargs)

    trainer.train_step = recording_step
    trainer.fit(_model(), data)
    want, unbucketed = [], []
    plain = data._loader(data.train_ds, shuffle=True)
    plain.length_hint = None
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        plain.set_epoch(epoch)
        want += _batch_keys(b for b, _ in loader.iter_with_counts())
        unbucketed += _batch_keys(b for b, _ in plain.iter_with_counts())
    assert seen == want and want != unbucketed
