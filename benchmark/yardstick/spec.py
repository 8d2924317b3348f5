"""Find everything by name: the benchmark's contract in ``BENCHMARK.json``
and the files that belong to one cell, configuration, traffic mix or
metric.

* a cell: its entry in ``BENCHMARK.json`` and ``cells/<cell>.json``
  (its configuration, its traffic mix, its limits and its own knobs);
* a configuration: ``configs/<config>.json`` (the model class, its
  published sizes, its reference in ``reference/``);
* a traffic mix: ``traffic/<mix>.json`` (the runner in ``runners/`` that
  runs it and its parameters);
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(ctx)``
  returns the number or None when there is nothing to read; a metric
  ``<base>.<kind>`` without a file of its own is read by
  ``metrics/<base>.py``.

A new cell, configuration, mix or metric is new files and entries; no
file that is there changes. A cell with a file under ``cells/`` and no
entry in ``BENCHMARK.json`` is a candidate: the benchmark's command does
not run it, its tools and tests do (:func:`with_cell`).
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict                     # the workloads entry of BENCHMARK.json
    spec: dict                      # cells/<name>.json
    config: dict                    # configs/<config>.json
    traffic: dict                   # traffic/<mix>.json, the cell's own knobs over it
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


def reports(metric: dict, cell: str, end_to_end_names) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    key lists, or without it every cell that reports the metric it moves
    (for an end-to-end metric: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in end_to_end_names


def load_cell(name: str, bench: Optional[dict] = None, root: Path = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else load_json(Path(root).parent / "BENCHMARK.json")
    root = Path(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    spec = load_json(root / "cells" / f"{name}.json")
    if spec["config"] != entry["config"] or spec["traffic"] != entry["traffic"]:
        raise ValueError(f"cells/{name}.json names another configuration or mix than "
                         f"BENCHMARK.json")
    config = load_json(root / "configs" / f"{entry['config']}.json")
    traffic = {**load_json(root / "traffic" / f"{entry['traffic']}.json"),
               **spec.get("traffic_overrides", {})}
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry, spec, config, traffic, e2e, per_layer)


def with_cell(bench: dict, name: str, root: Path = BENCH_DIR) -> dict:
    """``bench`` with the candidate cell ``name`` (``cells/<name>.json``)
    among its workloads on one chip; ``bench`` itself when it lists it."""
    if any(w["name"] == name for w in bench["workloads"]):
        return bench
    own = load_json(Path(root) / "cells" / f"{name}.json")
    entry = {"name": name, "config": own["config"], "traffic": own["traffic"], "chips": 1,
             "why": "candidate cell"}
    return {**bench, "workloads": bench["workloads"] + [entry]}


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_path(name: str, root: Path = BENCH_DIR) -> Path:
    """``metrics/<name>.py``, or ``metrics/<base>.py`` for ``<base>.<kind>``
    without a file of its own."""
    own = Path(root) / "metrics" / f"{name}.py"
    return own if own.is_file() else Path(root) / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str, root: Path = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """The metric's ``read`` (:func:`metric_path`)."""
    return _load_file(metric_path(name, root), "bench_metric_" + re.sub(r"\W", "_", name)).read


def runner(name: str, root: Path = BENCH_DIR):
    """``runners/<name>.py``: the module that runs a kind of traffic."""
    return _load_file(Path(root) / "runners" / f"{name}.py", f"bench_runner_{name}")


def check_names(bench: dict) -> List[str]:
    """The contract's rules on names and units that a file alone can break;
    returns what is wrong (empty when nothing is)."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for item in bench[group]:
            name = item["name"]
            if not NAME.match(name):
                bad.append(f"{group}: name {name!r}")
            if name in seen:
                bad.append(f"{group}: {name!r} twice")
            seen.add(name)
    for item in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(item[key]):
                bad.append(f"workloads: {key} {item[key]!r}")
    for item in bench["configs"]:
        for key in item["reduced"]:
            if not NAME.match(key):
                bad.append(f"configs: reduced key {key!r}")
    for item in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(item["unit"]):
            bad.append(f"unit {item['unit']!r} of {item['name']}")
        if item["better"] not in ("lower", "higher"):
            bad.append(f"better {item['better']!r} of {item['name']}")
    return bad
