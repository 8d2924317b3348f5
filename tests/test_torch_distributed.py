"""Data-parallel training of the port: gloo ranks on the CPU (PyTorch side).

Two processes at batch 2, joined by ``torch.distributed`` over gloo,
must train as one process at batch 4 (the counterpart of
``tests/test_distributed.py:127``, which holds the JAX package's
multi-process run to a single process at the global batch):

* the ASR config through the CLI (``fit --distributed``) on a corpus
  whose train split fills whole global batches, with augmentation and
  dropout on: per-step losses within 1e-5 relative, validation loss,
  CER and WER of the global batches, final weights within rtol 2e-5 /
  atol 2e-6 (the JAX test's bound), the device cache off with the JAX
  trainer's warning, and a ``restore_from`` run that continues as the
  single process's does;
* a small TTS audio model on WORLD batches whose lengths differ between
  the ranks' rows: the WORLD loss divides by the mask sum of the whole
  batch, so a loss averaged over the ranks' means would differ from the
  global batch's by far more than the tolerance (checked on the data);
* the 2-rank three-step trajectory with augmentation and dropout off
  against the JAX task and optax on the global batch, at the tolerances
  of ``tests/test_torch_train.py``;
* ranks whose batches collate to different shapes stop with the JAX
  trainer's error; rank 1 writes no log file and no checkpoint; one
  rank in a process group trains bit for bit as no group does.

Ranks are subprocesses (``tests/torch_dist_worker.py`` or the CLI) at one
torch thread each.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from corpus_fixture import make_dummy_corpus

import jax

from test_torch_train import HIDDEN, MELS, PARAM_ATOL, SETTINGS, VOCAB, _batches, _jax_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
W_RTOL, W_ATOL = 2e-5, 2e-6

ASR_CONFIG = """\
seed_everything: 1234
trainer:
  max_epochs: 2
  gradient_clip_val: 1.0
  log_every_n_steps: 1
{extra}model:
  class_path: voice100_tpu.models.AudioToAlignText
  init_args:
    vocab_size: 29
    audio_size: 64
    encoder_settings: [[16, false, 3, 2, 1, false]]
    decoder_num_layers: 2
    decoder_hidden_size: 16
data:
  class_path: voice100_tpu.data.AudioTextDataModule
  init_args:
    vocoder: mel
    dataset: dummy_en
    language: en
    batch_size: {batch_size}
    valid_ratio: 0.2
"""

TTS_ARGS = {"vocab_size": 29, "logspc_size": 25, "codeap_size": 1, "encoder_num_layers": 2,
            "encoder_hidden_size": 16,
            "decoder_settings": [[32, False, 3, 1, 1, False], [32, True, 5, 2, 2, False],
                                 [16, False, 3, 1, 1, True]]}
STATS = {"f0_mean": [150.0], "f0_std": [30.0], "logspc_mean": np.linspace(-6, 0.5, 25).tolist(),
         "logspc_std": np.linspace(0.2, 1.5, 25).tolist(), "codeap_mean": [-20.0],
         "codeap_std": [6.0]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _ranks(argv_of_rank, expect_ok=True):
    """Run ranks 0 and 1 together; returns their outputs."""
    procs = [subprocess.Popen(argv_of_rank(rank), cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:  # a rank left waiting on a collective must not outlive the test
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if expect_ok:
        for rank, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return procs, outs


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _weights(path):
    return torch.load(path, weights_only=True)["model"]


def _assert_weights_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=name)


def _assert_same_run(got, want):
    """Two fits' logs: the same steps, losses within LOSS_RTOL."""
    got = [r for r in got if "train_loss" in r]
    want = [r for r in want if "train_loss" in r]
    assert [(r["epoch"], r["step"]) for r in got] == [(r["epoch"], r["step"]) for r in want]
    for g, w in zip(got, want):
        for key in w:
            if key.startswith(("train_", "val_")) and key != "train_time_s":
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)


def _cli_fit(cfg, corpus, tmp_path, name, extra=()):
    return ["fit", "--config", str(cfg), "--data_dir", corpus, "--cache_dir",
            str(tmp_path / "cache"), "--checkpoint_dir", str(tmp_path / name), "--log_path",
            str(tmp_path / f"{name}.jsonl"), "--device", "cpu", *extra]


def test_two_asr_ranks_through_the_cli_train_as_one_process_at_the_global_batch(tmp_path):
    from voice100_tpu_torch.training.cli import main

    corpus = str(tmp_path / "data")
    make_dummy_corpus(corpus, n_clips=10, seed=5)  # 8 train clips: two global batches of 4
    one, two = tmp_path / "one.yaml", tmp_path / "two.yaml"
    one.write_text(ASR_CONFIG.format(batch_size=4, extra=""))
    two.write_text(ASR_CONFIG.format(
        batch_size=2, extra="  device_cache: true\n  steps_per_dispatch: 2\n"))
    main(_cli_fit(one, corpus, tmp_path, "p1"))  # also writes the feature cache the ranks read
    port = _free_port()

    def rank_argv(extra):
        return lambda rank: [sys.executable, "-m", "voice100_tpu_torch", *_cli_fit(
            two, corpus, tmp_path, "p2", extra), "--distributed", "--coordinator_address",
            f"localhost:{port}", "--num_processes", "2", "--process_id", str(rank)]

    _, outs = _ranks(rank_argv(()))
    assert "[trainer p0]" in outs[0] and "[trainer p1]" in outs[1]
    got, want = _records(tmp_path / "p2.jsonl"), _records(tmp_path / "p1.jsonl")
    start = next(r for r in got if r.get("event") == "fit_start")
    assert (start["processes"], start["devices"], start["steps_per_epoch"]) == (2, 2, 2)
    assert {"event": "warning", "message": "device_cache disabled: multi-process runs stream "
            "batches (per-host cache states would diverge)"} in got
    assert not any(r.get("event") in ("device_cache", "scan_dispatch") for r in got)
    # one writer: each step's record once
    assert [r["step"] for r in got if "train_loss" in r] == [1, 2, 2, 3, 4, 4]
    _assert_same_run(got, want)
    epochs = [r for r in got if "val_cer" in r]
    assert [(r["val_cer"], r["val_wer"]) for r in epochs] == [
        (r["val_cer"], r["val_wer"]) for r in want if "val_cer" in r]
    _assert_weights_close(_weights(tmp_path / "p2" / "last.pt"),
                          _weights(tmp_path / "p1" / "last.pt"))
    assert not [p for p in os.listdir(tmp_path / "p2") if p.endswith(".tmp")]

    # every rank restores last.pt and goes on, as one process does
    port = _free_port()
    _ranks(rank_argv(("--restore_from", str(tmp_path / "p2" / "last.pt"), "--max_epochs", "3")))
    main(_cli_fit(one, corpus, tmp_path, "p1", ("--restore_from",
                                                 str(tmp_path / "p1" / "last.pt"),
                                                 "--max_epochs", "3")))
    got, want = _records(tmp_path / "p2.jsonl"), _records(tmp_path / "p1.jsonl")
    assert [r["epoch"] for r in got if "train_time_s" in r] == [0, 1, 2]
    _assert_same_run(got, want)
    resumed = torch.load(tmp_path / "p2" / "last.pt", weights_only=True)
    assert (resumed["epoch"], resumed["step"]) == (3, 6)
    _assert_weights_close(resumed["model"], _weights(tmp_path / "p1" / "last.pt"))


def _world_batch(rng, f0_len, text_len, frames=64, tokens=16):
    """A collated WORLD batch of ``len(f0_len)`` rows at fixed extents,
    raw features drawn from ``STATS``, zero past each length."""
    rows = len(f0_len)
    f0_len, text_len = np.asarray(f0_len, np.int32), np.asarray(text_len, np.int32)
    valid = np.arange(frames)[None, :] < f0_len[:, None]

    def draw(stream, shape):
        return rng.normal(np.asarray(STATS[f"{stream}_mean"]), np.asarray(STATS[f"{stream}_std"]),
                          shape)

    f0 = np.where(rng.random((rows, frames)) < 0.3, 0.0, draw("f0", (rows, frames))) * valid
    logspc = draw("logspc", (rows, frames, 25)) * valid[:, :, None]
    codeap = np.where(rng.random((rows, frames, 1)) < 0.3, -1e-3,
                      np.minimum(draw("codeap", (rows, frames, 1)), -1.0)) * valid[:, :, None]
    text = rng.integers(1, 29, (rows, tokens)).astype(np.int32)
    text[np.arange(tokens)[None, :] >= text_len[:, None]] = 0
    return ((f0.astype(np.float32), f0_len, logspc.astype(np.float32), codeap.astype(np.float32)),
            (text, text_len))


def _worker_ranks(tmp_path, name, spec_of_rank, expect_ok=True):
    """Ranks 0 and 1 of ``tests/torch_dist_worker.py``, each with its spec."""
    port = _free_port()
    paths = []
    for rank in range(2):
        paths.append(tmp_path / f"{name}{rank}.json")
        paths[-1].write_text(json.dumps({**spec_of_rank(rank), "coordinator": f"localhost:{port}",
                                         "world": 2, "rank": rank}))
    return _ranks(lambda rank: [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
                                str(paths[rank])], expect_ok)


def test_two_tts_ranks_with_ragged_lengths_train_as_one_process(tmp_path):
    rng = np.random.default_rng(7)
    # the ranks' rows hold 84 and 37 voiced frames: unequal mask sums
    lengths = [((64, 20, 37, 0), (16, 5, 9, 1)), ((40, 61, 3, 12), (10, 16, 2, 3)),
               ((64, 64, 10, 30), (16, 16, 3, 8))]
    batches = tmp_path / "tts.pt"
    torch.save({"train": [_world_batch(rng, f, t) for f, t in lengths],
                "val": [_world_batch(rng, (50, 7, 64, 22), (12, 2, 16, 6))]}, batches)
    common = {"mode": "fit", "model": "tts", "model_args": TTS_ARGS, "norm": STATS,
              "batches": str(batches)}

    # the data tells the global batch's loss from the mean of the ranks' losses
    data = torch.load(batches, weights_only=False)
    model = worker.build_model(common)
    task = worker.make_task(model)
    with torch.no_grad():
        whole = float(task.loss(worker._tensors(data["train"][0]), train=False)[1]["loss"])
        halves = [float(task.loss(worker._tensors(worker._rows(data["train"][0], r, 2)),
                                  train=False)[1]["loss"]) for r in range(2)]
    assert abs(np.mean(halves) - whole) > 100 * LOSS_RTOL * abs(whole)

    cfg = {"max_epochs": 2, "log_every_n_steps": 1, "monitor": "val_loss"}
    worker.run({**common, "config": {**cfg, "checkpoint_dir": str(tmp_path / "p1"),
                                     "log_path": str(tmp_path / "p1.jsonl")}})
    _worker_ranks(tmp_path, "tts", lambda rank: {**common, "config": {
        **cfg, "checkpoint_dir": str(tmp_path / "p2"), "log_path": str(tmp_path / "p2.jsonl")}})
    got, want = _records(tmp_path / "p2.jsonl"), _records(tmp_path / "p1.jsonl")
    assert [r["step"] for r in got if "train_loss" in r] == [1, 2, 3, 3, 4, 5, 6, 6]
    assert all("val_loss" in r and "val_f0_loss" in r for r in got if "train_time_s" in r)
    _assert_same_run(got, want)
    for name in ("best.pt", "last.pt"):
        _assert_weights_close(_weights(tmp_path / "p2" / name), _weights(tmp_path / "p1" / name))


def test_two_ranks_follow_the_jax_task_and_optax_on_the_global_batch(tmp_path):
    """Augmentation and dropout off: the 2-rank trajectory against the
    JAX task + optax of ``tests/test_torch_train.py`` on the global batch."""
    from voice100_tpu.models import AudioToAlignText as JaxModel
    from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables

    import jax.numpy as jnp

    model = JaxModel(audio_size=MELS, vocab_size=VOCAB, encoder_settings=SETTINGS,
                     decoder_num_layers=2, decoder_hidden_size=HIDDEN)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 21, MELS)), jnp.asarray([21])))
    batches = _batches(3)
    want_losses, want_params = _jax_trajectory(model, variables, batches)

    torch.save(from_jax_variables(variables), tmp_path / "init.pt")
    torch.save({"train": batches}, tmp_path / "asr.pt")
    _worker_ranks(tmp_path, "steps", lambda rank: {
        "mode": "steps", "model": "asr", "batches": str(tmp_path / "asr.pt"),
        "weights": str(tmp_path / "init.pt"), "out": str(tmp_path / "out.pt"),
        "model_args": {"audio_size": MELS, "vocab_size": VOCAB, "encoder_settings": SETTINGS,
                       "decoder_num_layers": 2, "decoder_hidden_size": HIDDEN}})
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_variables(out["model"])["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_ranks_with_other_batch_shapes_stop_with_the_jax_trainers_error(tmp_path):
    rng = np.random.default_rng(0)
    batches = tmp_path / "b.pt"
    torch.save({"train": [_world_batch(rng, (20, 10, 30, 5), (5, 3, 8, 2))]}, batches)
    # rank 1 collates 48 frames where rank 0 collates 64
    torch.save({"train": [_world_batch(rng, (20, 10, 30, 5), (5, 3, 8, 2), frames=48)]},
               tmp_path / "b1.pt")
    procs, outs = _worker_ranks(tmp_path, "shape", lambda rank: {
        "mode": "fit", "model": "tts", "model_args": TTS_ARGS, "config": {"max_epochs": 1},
        "batches": str(batches if rank == 0 else tmp_path / "b1.pt")}, expect_ok=False)
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "multi-process batch shapes differ across hosts; pin one collate bucket" in out


def test_only_rank_zero_writes_the_log_and_checkpoints(tmp_path, monkeypatch):
    from voice100_tpu_torch.parallel import mesh as parallel
    from voice100_tpu_torch.training import (Trainer, TrainerConfig, TrainState, make_task,
                                             save_checkpoint)

    model = worker.build_model({"model": "tts", "model_args": TTS_ARGS})
    state = TrainState(model, make_task(model).make_optimizer())
    waits = []
    monkeypatch.setattr(parallel, "barrier", lambda: waits.append(1))
    for rank in (1, 0):
        monkeypatch.setattr(parallel, "process_index", lambda: rank)
        trainer = Trainer(TrainerConfig(log_path=str(tmp_path / f"log{rank}.jsonl")))
        trainer._log({"event": "x"})
        trainer.close()
        save_checkpoint(str(tmp_path / f"ck{rank}" / "last.pt"), state)
    assert sorted(os.listdir(tmp_path)) == ["ck0", "log0.jsonl"]
    assert waits == [1, 1]


def test_one_rank_in_a_process_group_trains_bit_for_bit_as_no_group(tmp_path):
    """The gradient all-reduce, the global denominators and draws of one
    rank change nothing (augmentation and dropout on)."""
    from voice100_tpu_torch.parallel import mesh as parallel

    batches = tmp_path / "asr.pt"
    torch.save({"train": _batches(2, seed=6)}, batches)
    spec = {"mode": "fit", "model": "asr", "batches": str(batches),
            "model_args": {"audio_size": MELS, "vocab_size": VOCAB, "encoder_settings": SETTINGS,
                           "decoder_num_layers": 2, "decoder_hidden_size": HIDDEN}}
    runs = []
    for group in (False, True):
        name = "group" if group else "plain"
        run = {**spec, "config": {"max_epochs": 2, "log_every_n_steps": 1, "monitor": "train_loss",
                                  "checkpoint_dir": str(tmp_path / name),
                                  "log_path": str(tmp_path / f"{name}.jsonl")}}
        counts = dict(parallel.collective_counts)
        if group:
            run.update(coordinator=f"localhost:{_free_port()}", world=1, rank=0)
        worker.run(run)
        runs.append(({k: parallel.collective_counts[k] - counts[k] for k in counts},
                     [r["train_loss"] for r in _records(tmp_path / f"{name}.jsonl")
                      if "train_loss" in r], _weights(tmp_path / name / "last.pt")))
    (plain_counts, plain_losses, plain_w), (counts, losses, w) = runs
    assert not any(plain_counts.values())
    assert counts["all_reduce_gradients"] == 4  # one a step
    assert losses == plain_losses
    assert all(torch.equal(w[k], plain_w[k]) for k in plain_w)
