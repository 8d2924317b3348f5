"""Tensor-parallel training of the port: gloo ranks on the CPU.

A ``(data, model)`` mesh over ``torch.distributed`` ranks shares each
global batch as a data-parallel world of the same size does, keeps each
rank's ``model``-axis shards of the parameters and Adam moments, and
gathers the full weights each step (``parallel/mesh.py``). Held here
(one step against the JAX package is in
``tests/test_torch_tensor_parallel_step.py``):

* a ``(1, 2)`` fit through the CLI bit for bit a 2-rank data-parallel
  fit, in float32 and bf16: every logged loss, the final weights and
  Adam moments; its ``last.pt`` has full-shape tensors, loads in
  ``load_model``, and resumes on the other layout (data-parallel to
  tensor-parallel and back) to the same run;
* a small TTS audio model on WORLD batches with ragged lengths, and the
  v1 ``AudioToTextCTC`` with its global flax BatchNorms (its 256-channel
  norms shard), at ``(1, 2)``, bit for bit their data-parallel runs;
  rank 1 writes no log and no checkpoint;
* a sharded parameter that gets no gradient, so that Adam keeps no
  state for it: the (1, 2) checkpoints still carry every other leaf's
  moments at full shape, bit for bit the data-parallel ones, and resume
  on either layout;
* a model axis that does not divide the ranks stops every rank before
  any step.

Ranks are subprocesses (``tests/torch_dist_worker.py`` or the CLI) at one
torch thread each.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from corpus_fixture import make_dummy_corpus
from test_torch_distributed import (REPO, STATS, _env, _free_port, _records, _world_batch)

ASR_CONFIG = """\
seed_everything: 1234
trainer:
  max_epochs: 2
  gradient_clip_val: 1.0
  log_every_n_steps: 1
model:
  class_path: voice100_tpu.models.AudioToAlignText
  init_args:
    vocab_size: 29
    audio_size: 64
    encoder_settings: [[16, false, 3, 2, 1, false]]
    decoder_num_layers: 2
    decoder_hidden_size: 64
data:
  class_path: voice100_tpu.data.AudioTextDataModule
  init_args:
    vocoder: mel
    dataset: dummy_en
    language: en
    batch_size: 2
    valid_ratio: 0.2
"""

# H=64: the gate matrices and biases (4H = 256) shard
TTS_ARGS = {"vocab_size": 29, "logspc_size": 25, "codeap_size": 1, "encoder_num_layers": 2,
            "encoder_hidden_size": 64,
            "decoder_settings": [[32, False, 3, 1, 1, False], [32, True, 5, 2, 2, False],
                                 [16, False, 3, 1, 1, True]]}


def _run_ranks(runs, timeout=300):
    """Start every run's ranks at once (``runs``: name -> argv of each
    rank) and wait for them all; returns name -> outputs. A rank that
    fails fails the test, after every process has ended."""
    procs = {name: [subprocess.Popen(argv, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True) for argv in argvs]
             for name, argvs in runs.items()}
    try:
        outs = {name: [p.communicate(timeout=timeout)[0] for p in ps]
                for name, ps in procs.items()}
    finally:  # a rank left waiting on a collective must not outlive the test
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {name: [(p.returncode, out) for p, out in zip(procs[name], outs[name])]
            for name in runs}


def _assert_ok(results):
    for name, ranks in results.items():
        for rank, (code, out) in enumerate(ranks):
            assert code == 0, f"{name} rank {rank} failed:\n{out[-4000:]}"


def _worker_argvs(tmp_path, name, world, spec_of_rank):
    port = _free_port()
    argvs = []
    for rank in range(world):
        path = tmp_path / f"{name}{rank}.json"
        path.write_text(json.dumps({**spec_of_rank(rank), "coordinator": f"localhost:{port}",
                                    "world": world, "rank": rank}))
        argvs.append([sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
                      str(path)])
    return argvs


def _cli_argvs(cfg, corpus, tmp_path, name, world=2, extra=()):
    port = _free_port()
    return [[sys.executable, "-m", "voice100_tpu_torch", "fit", "--config", str(cfg),
             "--data_dir", corpus, "--cache_dir", str(tmp_path / "cache"),
             "--checkpoint_dir", str(tmp_path / name), "--log_path",
             str(tmp_path / f"{name}.jsonl"), "--device", "cpu", "--distributed",
             "--coordinator_address", f"localhost:{port}", "--num_processes", str(world),
             "--process_id", str(rank), *extra] for rank in range(world)]


def _saved(path):
    return torch.load(path, weights_only=True)


def _assert_same_checkpoint(got, want):
    """Two checkpoints bit for bit: weights, every optimizer state tensor
    (Adam's moments at full shape), counters."""
    assert got["model"].keys() == want["model"].keys()
    for name, w in want["model"].items():
        assert got["model"][name].shape == w.shape and torch.equal(got["model"][name], w), name
    assert got["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    for i, state in want["optimizer"]["state"].items():
        for key, value in state.items():
            assert torch.equal(got["optimizer"]["state"][i][key], value), (i, key)
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    assert (got["step"], got["epoch"], got["best_monitor"]) == (
        want["step"], want["epoch"], want["best_monitor"])


def _losses(records):
    return [{k: v for k, v in r.items() if k.startswith(("train_", "val_", "epoch", "step"))
             and k != "train_time_s"} for r in records if "train_loss" in r]


# --- fits against data parallelism, bit for bit ------------------------------

@pytest.fixture(scope="module")
def asr_fits(tmp_path_factory):
    """Two-rank CLI fits of the ASR config, data-parallel and at (1, 2),
    in float32 and bf16 (all four at once), on a corpus whose 8 train
    clips fill two global batches of 4; the cache warmed first."""
    from voice100_tpu_torch.training.cli import main

    tmp_path = tmp_path_factory.mktemp("asr_fits")
    corpus = str(tmp_path / "data")
    make_dummy_corpus(corpus, n_clips=10, seed=5)
    cfg = tmp_path / "asr.yaml"
    cfg.write_text(ASR_CONFIG)
    main(["fit", "--config", str(cfg), "--data_dir", corpus, "--cache_dir",
          str(tmp_path / "cache"), "--checkpoint_dir", str(tmp_path / "warm"), "--max_epochs",
          "1", "--device", "cpu"])
    runs = {}
    for precision in ("32", "bf16"):
        for layout, extra in (("dp", ()), ("tp", ("--mesh_model_axis", "2"))):
            runs[f"{layout}{precision}"] = _cli_argvs(
                cfg, corpus, tmp_path, f"{layout}{precision}",
                extra=("--precision", precision, *extra))
    _assert_ok(_run_ranks(runs))
    return tmp_path, cfg, corpus


@pytest.mark.parametrize("precision", ["32", "bf16"])
def test_a_1x2_cli_fit_is_bit_equal_to_a_2_rank_dp_fit(asr_fits, precision):
    tmp_path, _, _ = asr_fits
    dp, tp = _records(tmp_path / f"dp{precision}.jsonl"), _records(tmp_path / f"tp{precision}.jsonl")
    start = next(r for r in tp if r.get("event") == "fit_start")
    assert start["mesh"] == {"data": 1, "model": 2} and start["processes"] == 2
    assert next(r for r in dp if r.get("event") == "fit_start")["mesh"] == {"data": 2,
                                                                           "model": 1}
    # one writer: each step's record once; every loss bit for bit
    assert [r["step"] for r in tp if "train_loss" in r] == [1, 2, 2, 3, 4, 4]
    assert _losses(tp) == _losses(dp)
    assert all(np.isfinite(r["val_loss"]) for r in tp if "val_loss" in r)
    for name in ("last.pt", "best.pt"):
        _assert_same_checkpoint(_saved(tmp_path / f"tp{precision}" / name),
                                _saved(tmp_path / f"dp{precision}" / name))
    assert not [p for p in os.listdir(tmp_path / f"tp{precision}") if p.endswith(".tmp")]


def test_a_tp_checkpoint_is_full_shape_and_resumes_on_either_layout(asr_fits):
    """``last.pt`` of the (1, 2) fit loads in ``load_model`` as the
    data-parallel one does, and a data-parallel checkpoint resumed at
    (1, 2) trains as the (1, 2) checkpoint resumed data-parallel."""
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.training.cli import load_model

    tmp_path, cfg, corpus = asr_fits
    tp_model = load_model(str(cfg), str(tmp_path / "tp32" / "last.pt"), device="cpu")
    dp_model = load_model(str(cfg), str(tmp_path / "dp32" / "last.pt"), device="cpu")
    assert isinstance(tp_model, AudioToAlignText)
    for (name, a), b in zip(tp_model.state_dict().items(), dp_model.state_dict().values()):
        assert torch.equal(a, b), name
    assert _saved(tmp_path / "tp32" / "last.pt")["model"]["lstm.weight_ih_l0"].shape == (256, 16)

    runs = {"dp_to_tp": _cli_argvs(cfg, corpus, tmp_path, "dp_to_tp", extra=(
                "--restore_from", str(tmp_path / "dp32" / "last.pt"), "--max_epochs", "3",
                "--mesh_model_axis", "2")),
            "tp_to_dp": _cli_argvs(cfg, corpus, tmp_path, "tp_to_dp", extra=(
                "--restore_from", str(tmp_path / "tp32" / "last.pt"), "--max_epochs", "3"))}
    _assert_ok(_run_ranks(runs))
    a, b = _records(tmp_path / "dp_to_tp.jsonl"), _records(tmp_path / "tp_to_dp.jsonl")
    assert [r["epoch"] for r in a if "train_time_s" in r] == [2]
    assert _losses(a) == _losses(b)
    resumed = _saved(tmp_path / "dp_to_tp" / "last.pt")
    assert (resumed["epoch"], resumed["step"]) == (3, 6)
    _assert_same_checkpoint(resumed, _saved(tmp_path / "tp_to_dp" / "last.pt"))


def _fit_pair(tmp_path, name, common, cfg):
    """The data-parallel and (1, 2) runs of ``common`` at once; rank 1 of
    each is given its own log and checkpoint paths, which must stay
    unwritten."""
    def spec(layout, extra):
        def of_rank(rank):
            tag = f"{name}_{layout}" if rank == 0 else f"{name}_{layout}_rank1"
            return {**common, "config": {**cfg, **extra,
                                         "checkpoint_dir": str(tmp_path / tag),
                                         "log_path": str(tmp_path / f"{tag}.jsonl")}}
        return of_rank

    _assert_ok(_run_ranks({
        "dp": _worker_argvs(tmp_path, f"{name}_dp", 2, spec("dp", {})),
        "tp": _worker_argvs(tmp_path, f"{name}_tp", 2, spec("tp", {"mesh_model_axis": 2}))}))
    for layout in ("dp", "tp"):
        assert not (tmp_path / f"{name}_{layout}_rank1").exists()
        assert not (tmp_path / f"{name}_{layout}_rank1.jsonl").exists()
    dp, tp = (_records(tmp_path / f"{name}_{layout}.jsonl") for layout in ("dp", "tp"))
    assert _losses(tp) == _losses(dp) and len(_losses(tp)) > 0
    for ckpt in ("best.pt", "last.pt"):
        _assert_same_checkpoint(_saved(tmp_path / f"{name}_tp" / ckpt),
                                _saved(tmp_path / f"{name}_dp" / ckpt))
    return tp


def test_a_tts_model_with_ragged_lengths_at_1x2_is_bit_equal_to_dp(tmp_path):
    rng = np.random.default_rng(7)
    lengths = [((64, 20, 37, 0), (16, 5, 9, 1)), ((40, 61, 3, 12), (10, 16, 2, 3))]
    torch.save({"train": [_world_batch(rng, f, t) for f, t in lengths],
                "val": [_world_batch(rng, (50, 7, 64, 22), (12, 2, 16, 6))]},
               tmp_path / "tts.pt")
    common = {"mode": "fit", "model": "tts", "model_args": TTS_ARGS, "norm": STATS,
              "batches": str(tmp_path / "tts.pt")}
    records = _fit_pair(tmp_path, "tts", common,
                        {"max_epochs": 2, "log_every_n_steps": 1, "monitor": "val_loss"})
    assert all("val_f0_loss" in r for r in records if "train_time_s" in r)


def test_a_v1_model_with_global_batchnorm_at_1x2_is_bit_equal_to_dp(tmp_path):
    from test_torch_v1_train import ASR_ARGS, _batches

    torch.save({"train": _batches(2, seed=11), "val": _batches(1, seed=12)},
               tmp_path / "asr_v1.pt")
    common = {"mode": "fit", "model": "asr_v1", "model_args": ASR_ARGS,
              "batches": str(tmp_path / "asr_v1.pt")}
    _fit_pair(tmp_path, "asr_v1", common,
              {"max_epochs": 2, "log_every_n_steps": 1, "monitor": "val_loss"})
    weights = _saved(tmp_path / "asr_v1_tp" / "last.pt")["model"]
    assert any("running_mean" in k for k in weights)


def test_a_sharded_parameter_without_adam_state_round_trips_on_both_layouts(tmp_path):
    from voice100_tpu_torch.models import AlignTextToAudio

    frozen = "lstm.bias_hh_l1_reverse"  # 4H = 256: sharded
    rng = np.random.default_rng(9)
    torch.save({"train": [_world_batch(rng, (64, 20, 37, 9), (16, 5, 9, 3))],
                "val": [_world_batch(rng, (50, 7, 64, 22), (12, 2, 16, 6))]},
               tmp_path / "tts.pt")
    common = {"mode": "fit", "model": "tts", "model_args": TTS_ARGS, "norm": STATS,
              "batches": str(tmp_path / "tts.pt"), "frozen": [frozen]}
    cfg = {"max_epochs": 1, "log_every_n_steps": 1}
    _fit_pair(tmp_path, "frozen", common, cfg)
    names = [n for n, _ in AlignTextToAudio(**TTS_ARGS, device="cpu").named_parameters()]
    saved = _saved(tmp_path / "frozen_tp" / "last.pt")
    assert sorted(saved["optimizer"]["state"]) == [
        i for i, n in enumerate(names) if n != frozen]
    for i, state in saved["optimizer"]["state"].items():
        assert state["exp_avg"].shape == saved["model"][names[i]].shape, names[i]

    def resumed(name, source, extra):
        def of_rank(rank):
            tag = name if rank == 0 else f"{name}_rank1"
            return {**common, "restore_from": str(tmp_path / source / "last.pt"),
                    "config": {**cfg, **extra, "max_epochs": 2,
                               "checkpoint_dir": str(tmp_path / tag),
                               "log_path": str(tmp_path / f"{tag}.jsonl")}}
        return _worker_argvs(tmp_path, name, 2, of_rank)

    _assert_ok(_run_ranks({"dp_to_tp": resumed("frozen_dp_to_tp", "frozen_dp",
                                               {"mesh_model_axis": 2}),
                           "tp_to_dp": resumed("frozen_tp_to_dp", "frozen_tp", {})}))
    a, b = (_records(tmp_path / f"frozen_{n}.jsonl") for n in ("dp_to_tp", "tp_to_dp"))
    assert _losses(a) == _losses(b) and [r["epoch"] for r in a if "train_time_s" in r] == [1]
    _assert_same_checkpoint(_saved(tmp_path / "frozen_dp_to_tp" / "last.pt"),
                            _saved(tmp_path / "frozen_tp_to_dp" / "last.pt"))


def test_a_model_axis_that_does_not_divide_the_ranks_stops_before_any_step(tmp_path):
    corpus = str(tmp_path / "data")
    make_dummy_corpus(corpus, n_clips=4, seed=1)
    cfg = tmp_path / "asr.yaml"
    cfg.write_text(ASR_CONFIG)
    results = _run_ranks({"bad": _cli_argvs(cfg, corpus, tmp_path, "bad",
                                            extra=("--mesh_model_axis", "4"))})
    for code, out in results["bad"]:
        assert code != 0
        assert "mesh_model_axis=4 needs a multiple of 4 processes" in out and "got 2" in out
    assert not (tmp_path / "bad").exists()
    assert not (tmp_path / "bad.jsonl").exists() or not _records(tmp_path / "bad.jsonl")
