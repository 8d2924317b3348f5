"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, the comparison with the reference, the result.

A runner (``runners/<name>.py``, named by the cell's traffic mix) builds
the system under test, warms it up, measures the window and returns a
:class:`RunResult`; this module turns that into the result line.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from . import compare, guard, spec, synth
from .trace import TraceSummary, breakdown


@dataclass
class RunContext:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                      # perf_counter at the process's start
    config: Dict[str, Any] = field(default_factory=dict)   # the configuration, overrides applied
    traffic: Dict[str, Any] = field(default_factory=dict)  # the mix, overrides applied
    # called with the runner's objects before the window: tests break the
    # timed path here
    hooks: Dict[str, Callable] = field(default_factory=dict)

    @property
    def init_args(self) -> dict:
        return self.config["init_args"]


@dataclass
class RunResult:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, float]          # the numbers that decide correct
    setup_s: float
    memory_peak_bytes: int
    layer_ctx: Dict[str, Any] = field(default_factory=dict)
    summary: Optional[TraceSummary] = None
    notes: Dict[str, Any] = field(default_factory=dict)


def build_model(rc: RunContext):
    """The configuration's model on the run's device with weights drawn from
    the seed (one uniform and one normal draw on the device); returns the
    model and a copy of its initial weights by name."""
    from voice100_tpu_torch import models

    cls = getattr(models, rc.config["class"])
    model = cls(**rc.init_args, device=rc.device)
    weights = synth.fill_weights(model, synth.torch_seed(rc.seed, 10))
    return model, weights


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def card() -> Dict[str, Any]:
    """The card's name, power limit and SM clock as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    parts = [p.strip() for p in out[0].split(",")]
    return {"name": parts[0], "power_limit": parts[1] if len(parts) > 1 else None,
            "sm_clock_max": parts[2] if len(parts) > 2 else None}


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: Optional[dict] = None, hooks: Optional[dict] = None,
             t_start: Optional[float] = None, bench: Optional[dict] = None,
             root=spec.BENCH_DIR) -> dict:
    """Run one cell once; returns the result line's object. ``overrides``
    (``{"config": {...}, "traffic": {...}, "limits": {...}}``) shrink a
    cell for the CPU tests; a measured run takes none. ``root`` is the
    benchmark's folder, with ``BENCHMARK.json`` beside it."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(name, bench, root)
    overrides = overrides or {}
    rc = RunContext(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                    device=torch.device(device), t_start=t_start,
                    config=_merge(cell.config, overrides.get("config")),
                    traffic=_merge(cell.traffic, overrides.get("traffic")), hooks=hooks or {})
    if rc.device.type == "cuda":
        torch.cuda.set_device(rc.device)
        torch.cuda.reset_peak_memory_stats(rc.device)
    result = spec.runner(cell.traffic["runner"], root).run(rc)
    limits = {**cell.limits, **overrides.get("limits", {})}
    correct, checks = compare.judge(result.compared, limits)
    correct = correct and result.failed == 0 and result.attempted > 0
    if result.failed:
        checks["failed"] = {"value": result.failed, "limit": 0}
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(result.attempted),
                           "failed": int(result.failed)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(result.layer_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(result.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": float(result.setup_s), "unit": "s"}
    out["metrics"] = metrics
    dev = {"platform": "gpu" if rc.device.type == "cuda" else rc.device.type,
           "kind": (torch.cuda.get_device_name(rc.device) if rc.device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(result.memory_peak_bytes)}
    if trace and result.summary is not None:
        dev["busy_s"] = result.summary.busy_s
        dev["window_s"] = result.summary.window_s
    out["device"] = dev
    if trace and result.summary is not None:
        out["breakdown"] = breakdown(result.summary)
    out["card"] = card() if rc.device.type == "cuda" else {}
    out["notes"] = result.notes
    out["checks"] = checks
    return out


def report(out: dict) -> int:
    """Print the checks on standard error and the result as the last line
    of standard output; refuse (exit 3, no result) when JAX or the JAX
    package was loaded."""
    found = guard.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)} (JAX or the JAX package); "
              f"no result", file=sys.stderr, flush=True)
        return 3
    import json

    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
