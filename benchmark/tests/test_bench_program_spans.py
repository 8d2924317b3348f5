"""The per-layer metrics that read the program's own spans and counters
(``yardstick/program_spans.py``), on tiny traced CPU runs of the cells.

Every such metric reads a number in each cell it lists; the trainer's
three phases fit inside the benchmark's span around ``train_step``, and
the pipeline's five phases inside the program's ``asr.transcribe``. A
program without the table, or a window without the root span, reads
None and raises nothing.
"""

import pytest

from bench_tiny import OVERRIDES
from yardstick import harness, program_spans, spec

BENCH = spec.load_json(spec.REPO_ROOT / "BENCHMARK.json")
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if "program_spans" in spec.metric_path(m["name"]).read_text()]
CELLS = sorted({c for m in SPAN_METRICS for c in m["workloads"]})
PHASES = ("pad", "upload", "dispatch", "fetch", "text")


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced result and the program's table after it."""
    out = {}
    for cell in CELLS:
        result = harness.run_cell(cell, 2 ** 31 + 17, 0.5, True, device="cpu",
                                  overrides=OVERRIDES[cell])
        out[cell] = (result, program_spans.table())
    return out


def test_the_metrics_are_the_ones_the_program_feeds():
    assert len(SPAN_METRICS) == 11
    assert {m["source"] for m in SPAN_METRICS} == {"program_span", "program_counter"}
    assert set(CELLS) == {"asr_en_base.train_librispeech", "tts_en_base.train_ljspeech",
                          "asr_en_base.transcribe_bulk"}


@pytest.mark.parametrize("metric,cell", [(m["name"], c) for m in SPAN_METRICS
                                         for c in m["workloads"]])
def test_each_metric_reads_in_its_cells(traced, metric, cell):
    result, _ = traced[cell]
    assert result["correct"]
    value = result["metrics"][metric]["value"]
    assert value >= 0 and (value > 0 or metric.startswith("allocator_calls."))


@pytest.mark.parametrize("cell", ["asr_en_base.train_librispeech", "tts_en_base.train_ljspeech"])
def test_the_step_phases_fit_inside_the_step(traced, cell):
    metrics = {k: v["value"] for k, v in traced[cell][0]["metrics"].items()}
    phases = sum(metrics[f"step_{p}_ms.train"] for p in ("forward", "backward", "update"))
    assert phases <= metrics["step_enqueue_ms.train"]


def test_the_pipeline_phases_fit_inside_the_call(traced):
    result, table = traced["asr_en_base.transcribe_bulk"]
    calls, seconds = table["spans"]["asr.transcribe"]
    phases = sum(result["metrics"][f"pipeline_{p}_ms.transcribe"]["value"] for p in PHASES)
    assert calls == result["notes"]["calls"] and phases <= 1e3 * seconds / calls


@pytest.mark.parametrize("kept", [None, {"spans": {}, "counters": {}}])
def test_no_table_or_no_root_reads_none(monkeypatch, kept):
    from voice100_tpu_torch.utils import profiling

    if kept is None:
        monkeypatch.delattr(profiling, "table")
    else:
        monkeypatch.setattr(profiling, "table", lambda: kept)
    for m in SPAN_METRICS:
        assert spec.metric_reader(m["name"])({}) is None
