"""The port's profiling utilities and the trainer's ``profile_dir`` (CPU).

The narrow config of test_torch_cli.py on an 8-clip dummy_en corpus (6
train clips, batch 4: two steps an epoch):

* a fit with ``profile_dir`` writes a Chrome trace of steps 2-4 there,
  logs ``{"event": "profile_written", "dir": ...}`` once, and its losses
  equal the same fit's without it; through the CLI, the config key no
  longer raises;
* ``steps_per_dispatch > 1`` with ``profile_dir`` takes the per-step path
  (``voice100_tpu/training/trainer.py:623``);
* a stop request mid-trace closes the trace and writes it;
* ``Timer``, ``device_sync`` and ``realtime_factor`` behave as the JAX
  module's on the CPU.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json
import os

import numpy as np
import pytest

import torch

from corpus_fixture import make_dummy_corpus
from test_torch_cli import tiny_config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("profile_data"))
    make_dummy_corpus(data_dir, n_clips=8)
    return data_dir


def _data(corpus, tmp_path):
    from voice100_tpu_torch.data import AudioTextDataModule

    return AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=corpus,
                               cache_dir=str(tmp_path / "cache"), batch_size=4, valid_ratio=0.25,
                               device="cpu")


def _model():
    from test_torch_cli import HIDDEN, SETTINGS
    from voice100_tpu_torch.models import AudioToAlignText

    return AudioToAlignText(64, 29, SETTINGS, 1, HIDDEN, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def _fit(corpus, tmp_path, name, trainer_cls=None, **config):
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    log = str(tmp_path / f"{name}.jsonl")
    trainer = (trainer_cls or Trainer)(TrainerConfig(max_epochs=3, monitor="train_loss",
                                                     log_every_n_steps=1, log_path=log,
                                                     **config))
    state = trainer.fit(_model(), _data(corpus, tmp_path))
    trainer.close()
    assert trainer._trace is None
    return state, [json.loads(line) for line in open(log)]


def _traces(path):
    files = sorted(os.listdir(path)) if os.path.isdir(path) else []
    assert all(f.endswith(".pt.trace.json") for f in files)
    return [json.load(open(os.path.join(path, f))) for f in files]


def _losses(records):
    return [(r["step"], r["train_loss"]) for r in records
            if "train_loss" in r and "train_time_s" not in r]


def test_profiled_fit_writes_a_trace_and_trains_as_unprofiled(corpus, tmp_path):
    prof = str(tmp_path / "prof")
    state, records = _fit(corpus, tmp_path, "profiled", profile_dir=prof)
    _, plain = _fit(corpus, tmp_path, "plain")
    assert state.step == 6
    assert [r for r in records if r.get("event") == "profile_written"] == [
        {"event": "profile_written", "dir": prof}]
    # logged after step 5, the last step the trace holds, before its step record
    written = records.index({"event": "profile_written", "dir": prof})
    assert records[written + 1]["step"] == 5
    (trace,) = _traces(prof)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv1d" in n or "convolution" in n for n in names)
    assert _losses(records) == _losses(plain) and len(_losses(plain)) == 6


def test_dispatch_falls_back_to_per_step_under_profile_dir(corpus, tmp_path):
    config = dict(device_cache=True, steps_per_dispatch=2)
    _, dispatched = _fit(corpus, tmp_path, "dispatched", **config)
    assert any(r.get("event") == "scan_dispatch" for r in dispatched)
    prof = str(tmp_path / "prof")
    _, records = _fit(corpus, tmp_path, "profiled", profile_dir=prof, **config)
    assert not any(r.get("event") == "scan_dispatch" for r in records)
    assert [s for s, _ in _losses(records)] == list(range(1, 7))  # a record a step
    assert len(_traces(prof)) == 1


def test_a_stop_mid_trace_closes_it(corpus, tmp_path):
    from voice100_tpu_torch.training import Trainer

    class StopAtStep3(Trainer):
        def train_step(self, task, state, batch, generator=None, train=True):
            metrics = super().train_step(task, state, batch, generator, train)
            if state.step == 3:
                self.request_stop()
            return metrics

    prof = str(tmp_path / "prof")
    state, records = _fit(corpus, tmp_path, "stopped", trainer_cls=StopAtStep3, profile_dir=prof)
    assert state.step == 3
    assert {"event": "stopped", "epoch": 1, "step": 3} in records
    assert not any(r.get("event") == "profile_written" for r in records)
    (trace,) = _traces(prof)
    assert trace["traceEvents"]


def test_cli_fit_takes_profile_dir(corpus, tmp_path):
    from voice100_tpu_torch.training.cli import cli_main

    prof = str(tmp_path / "prof")
    cfg = tiny_config(tmp_path / "tiny.yaml", profile_dir=prof, max_epochs=3)
    log = str(tmp_path / "log.jsonl")
    cli_main(["fit", "--config", cfg, "--device", "cpu", "--data_dir", corpus,
              "--cache_dir", str(tmp_path / "cache"), "--checkpoint_dir", str(tmp_path / "ckpt"),
              "--log_path", log])
    records = [json.loads(line) for line in open(log)]
    assert {"event": "profile_written", "dir": prof} in records
    assert len(_traces(prof)) == 1


def test_timer_device_sync_and_realtime_factor_match_jax():
    from voice100_tpu.utils import profiling as jax_profiling
    from voice100_tpu_torch.utils import Timer, device_sync, realtime_factor

    for audio, wall in ((10.0, 2.0), (3.0, 0.0), (0.0, 1.5), (1.0, 1e-12)):
        assert realtime_factor(audio, wall) == jax_profiling.realtime_factor(audio, wall)
    x = torch.ones(3)
    device_sync(x, x[:1], np.ones(2), 3.0)  # host tensors and other objects: no wait
    for cls in (Timer, jax_profiling.Timer):
        with cls() as t:
            pass
        assert t.elapsed is not None and t.elapsed >= 0.0
        with cls() as t:
            elapsed = t.stop(np.ones(2))
        assert t.elapsed == elapsed >= 0.0  # stop's reading stands after the block
