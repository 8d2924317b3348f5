"""The harness's arithmetic, its contract file, its discovery by name and
its guard against JAX, on the CPU."""

import json
import math
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from bench_tiny import OVERRIDES
from yardstick import guard, harness, roofline, spec, window

BENCH = spec.load_json(spec.REPO_ROOT / "BENCHMARK.json")


# -- window arithmetic -----------------------------------------------------------

def test_rate_is_all_work_over_the_whole_window():
    assert window.rate(1500.0, 0.5) == 3000.0
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)


def test_percentile_matches_numpy_and_counts_failures_as_missing():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=401))
    for q in (50, 95, 99):
        assert window.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    with_failures = xs[:-25] + [math.inf] * 25
    assert math.isinf(window.percentile(with_failures, 95))


def test_spread_is_quartile_distance_over_median():
    assert window.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


class _StallingServer:
    """Answers in 2 ms; the request numbered ``stall`` takes 300 ms."""

    def __init__(self, stall):
        self.stall = stall

    def handle_transcribe(self, body, headers):
        time.sleep(0.3 if body == self.stall else 0.002)
        return {"text": ""}


@pytest.mark.parametrize("stall", [None, 5])
def test_open_loop_tail_moves_with_one_stall(stall):
    """Latency runs from when a request was due: one stall behind a single
    client delays the requests due after it, and the p95 over all requests
    moves with it."""
    serve = spec.runner("serve")
    due = np.arange(40) * 0.01
    load = serve.LoadGenerator(_StallingServer(stall), clients=1)
    t0 = time.perf_counter()
    sent, done, answers, errors, stuck = load.run(t0, due, lambda i: i)
    latency = [d - t0 - u for d, u in zip(done, due)]
    p95 = window.percentile(latency, 95)
    assert not stuck and all(a == "" for a in answers)
    if stall is None:
        assert p95 < 0.05
    else:
        assert p95 > 0.15


# -- counts --------------------------------------------------------------------------

def test_kernel_counts_by_hand():
    # kernel 1 at B=2, T=4, H=2, lengths 3 and 1: 4 valid rows a direction
    valid, h = 4, 2
    n_bytes = (2 * valid * 4 * h + 2 * 4 * h * h + 2 * 4 * 2 * h) * 4
    n_ops = 2 * valid * 8 * h * h
    expect = max(n_bytes / roofline.HBM_BYTES_PER_S, n_ops / roofline.PEAK_F32_FLOPS)
    assert roofline.bilstm_infer_launch(2, 4, h, [3, 1]) == pytest.approx(expect)
    state = 2 * 4 * 2 * h * 4
    assert roofline.bilstm_train_fwd_launch(2, 4, h, [3, 1]) == pytest.approx(max(
        (2 * valid * 4 * h * 4 + 2 * 4 * h * h * 4 + 3 * state) / roofline.HBM_BYTES_PER_S,
        n_ops / roofline.PEAK_F32_FLOPS))
    assert roofline.bilstm_train_bwd_launches(2, 4, h, [3, 1]) == pytest.approx(max(
        (2 * valid * 7 * h * 4 + 2 * 4 * h * h * 4 + 4 * state) / roofline.HBM_BYTES_PER_S,
        2 * n_ops / roofline.PEAK_F32_FLOPS))
    # CTC at B=1, T=5, V=3, label pad 2 (S=5), input 5, labels 2: 25 states
    lattice, const = 5 * 1 * 5 * 4, 3 * 1 * 5 * 4 + 4
    assert roofline.ctc_alpha_launch(1, 5, 3, 2, [5], [2]) == pytest.approx(max(
        (15 * 4 + const + lattice) / roofline.HBM_BYTES_PER_S, 250 / roofline.PEAK_F32_FLOPS))
    assert roofline.ctc_adjoint_launch(1, 5, 3, 2, [5], [2]) == pytest.approx(max(
        (2 * lattice + const + 5 * 4) / roofline.HBM_BYTES_PER_S, 250 / roofline.PEAK_F32_FLOPS))


def test_model_flops_by_hand():
    asr = {"audio_size": 4, "vocab_size": 3, "decoder_num_layers": 1, "decoder_hidden_size": 2,
           "encoder_settings": [[6, False, 3, 2, 1, False]]}
    # 9 frames -> (9 + 2 - 3) // 2 + 1 = 5; conv 5 * 2*3*4*6; LSTM 5 * 2 dirs *
    # (2*8*6 + 2*8*2); dense 5 * 2*4*3
    expect = 5 * 2 * 3 * 4 * 6 + 5 * 2 * (2 * 8 * 6 + 2 * 8 * 2) + 5 * 2 * 4 * 3
    assert roofline.asr_v2_forward_flops(asr, [9]) == expect
    tts = {"encoder_hidden_size": 2, "encoder_num_layers": 1, "f0_size": 1, "logspc_size": 1,
           "codeap_size": 1, "decoder_settings": [[3, True, 3, 2, 1, False]]}
    # 4 tokens: LSTM 4 * 2 * (2*8*2 + 2*8*2); transposed conv over its 4
    # inputs 4 * 2*3*4*3, output (4-1)*2 - 2 + 3 = 7 frames; projection 7 * 2*3*5
    expect = 4 * 2 * (2 * 8 * 2 + 2 * 8 * 2) + 4 * 2 * 3 * 4 * 3 + 7 * 2 * 3 * 5
    assert roofline.tts_v2_forward_flops(tts, [4]) == expect
    assert roofline.train_flops(10.0) == 30.0


# -- the contract file ------------------------------------------------------------------

def test_names_and_units_keep_the_contract():
    assert spec.check_names(BENCH) == []
    for bad in ("a b", "a,b", "a/b", "µs", "", "x" * 65):
        assert not spec.NAME.match(bad)
    for bad in ("tokens per second", "µs", "x" * 17):
        assert not spec.UNIT.match(bad)
    assert spec.UNIT.match("audio-s/s") and spec.UNIT.match("%")


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert spec.metric_path(m["name"]).is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"], BENCH)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end) and cell.per_layer
    for c in BENCH["configs"]:
        assert (spec.REPO_ROOT / c["file"]).is_file()
        assert spec.load_json(spec.REPO_ROOT / c["file"])["reduced"] == c["reduced"]


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell and a per-layer metric by new
    files and entries alone; the harness finds and runs both."""
    root = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cell = "asr_en_base.train_short"
    bench["workloads"].append({"name": cell, "config": "asr_en_base", "traffic": "train_short",
                               "chips": 1, "why": "short clips"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "training.trainer",
                               "moves": "train_audio_s_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = spec.load_json(root / "traffic" / "train_librispeech.json")
    mix["seconds"] = OVERRIDES["asr_en_base.train_librispeech"]["traffic"]["seconds"]
    (root / "traffic" / "train_short.json").write_text(json.dumps(mix))
    limits = spec.load_json(root / "cells" / "asr_en_base.train_librispeech.json")["limits"]
    (root / "cells" / f"{cell}.json").write_text(json.dumps(
        {"config": "asr_en_base", "traffic": "train_short", "limits": limits}))
    (root / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return ctx.get('steps') or None\n")
    found = spec.load_cell(cell, root=root)
    assert [m["name"] for m in found.per_layer] == ["steps_seen.train"]
    tiny = {"config": OVERRIDES["asr_en_base.train_librispeech"]["config"],
            "traffic": {"batch_size": 4, "pool": 32}}
    out = harness.run_cell(cell, 7, 0.5, True, device="cpu", overrides=tiny, root=root)
    assert out["correct"] and out["metrics"]["steps_seen.train"]["value"] >= 1


# -- JAX stays out ------------------------------------------------------------------------

def test_guard_compares_top_level_names_whole():
    names = ["voice100_tpu_torch", "voice100_tpu_torch.models", "jaxtyping", "flaxen.x",
             "numpy"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["jax.numpy", "voice100_tpu.models", "jaxlib",
                                            "flax.linen"]) == [
        "flax", "jax", "jaxlib", "voice100_tpu"]


def test_report_refuses_when_jax_was_loaded(monkeypatch, capsys):
    out = {"correct": True, "checks": {}}
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.report(out) == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
    monkeypatch.delitem(sys.modules, "jax")
    assert harness.report(out) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys, json; sys.path[:0] = [{bench!r}, {repo!r}, {tests!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from bench_tiny import OVERRIDES\n"
        "from yardstick import harness, guard\n"
        "out = harness.run_cell('asr_en_base.transcribe_bulk', 3, 0.3, False, device='cpu',"
        " overrides=OVERRIDES['asr_en_base.transcribe_bulk'])\n"
        "print(json.dumps([out['correct'], guard.forbidden_modules()]))\n"
    ).format(bench=str(spec.BENCH_DIR), repo=str(spec.REPO_ROOT),
             tests=str(spec.BENCH_DIR / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_run_without_a_card_exits_without_a_result():
    res = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                          "asr_en_base.train_librispeech", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(spec.REPO_ROOT))
    assert res.returncode != 0 and res.stdout == ""
