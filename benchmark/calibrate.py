"""Readings for the limits of ``correct``: the program's compared numbers
over many seeds and those of a planted fault or the control
(``control_tf32``: the reference in TF32 in the program's place), each
cell in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--fault control_tf32 --fault_seeds 4,5,6] [--seconds 2]

Prints one JSON line a run (``kind``: program or the fault's name;
``compared``: the numbers the harness judged) and a summary line. Not run
by the benchmark's own runs; it sets no limit itself. A candidate cell
(a file under ``cells/`` that ``BENCHMARK.json`` does not list) runs too.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, default=[])
    parser.add_argument("--fault", default=None)
    parser.add_argument("--fault_seeds", type=_ints, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    from yardstick import faults, harness, spec

    bench = spec.with_cell(spec.load_json(BENCH_DIR.parent / "BENCHMARK.json"), args.workload)
    # the training cells' readings are the checked steps: no window
    seconds = 0.0 if "train" in args.workload else args.seconds
    summary = {}
    runs = [("program", s) for s in args.seeds] + [(args.fault, s) for s in args.fault_seeds]
    for kind, seed in runs:
        hooks = {} if kind == "program" else {"program": faults.FAULTS[kind]}
        t = time.perf_counter()
        out = harness.run_cell(args.workload, seed, seconds, False, device=args.device,
                               hooks=hooks, bench=bench)
        values = {k: c["value"] for k, c in out["checks"].items()}
        print(json.dumps({"kind": kind, "seed": seed, "compared": values,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in values.items():
            summary.setdefault(kind, {}).setdefault(k, []).append(v)
    stats = {kind: {k: {"max": max(v), "min": min(v), "n": len(v)} for k, v in d.items()}
             for kind, d in summary.items()}
    print(json.dumps({"summary": stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
