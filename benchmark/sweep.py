"""The served cell at several fixed rates, to find the highest rate the
system sustains without a growing backlog (the knee), once.

    python3 benchmark/sweep.py --workload asr_en_base.serve_poisson \
        --rates 100,200,300 --seconds 10 --seed 1

Prints a JSON line a rate: offered and completed rates, p50 and p95
latency, the senders' lateness, the median latency in each third of the
window (a backlog that grows shows as a rising median) and correct."""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--trace", type=int, default=0)
    args = parser.parse_args(argv)
    from yardstick import harness, spec

    bench = spec.with_cell(spec.load_json(BENCH_DIR.parent / "BENCHMARK.json"), args.workload)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        out = harness.run_cell(args.workload, args.seed + k, args.seconds, bool(args.trace),
                               device="cuda:0", overrides={"traffic": {"rate_per_s": rate}},
                               bench=bench)
        notes = out["notes"]
        print(json.dumps({"rate_per_s": rate, "completed_per_s": notes["completed_per_s"],
                          "p95_ms": notes["p95_ms"], "p50_ms": notes["p50_ms"],
                          "median_ms_by_third": notes["median_ms_by_third"],
                          "failed": out["failed"], "attempted": out["attempted"],
                          "correct": out["correct"], "device": out["device"],
                          "breakdown": out.get("breakdown")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
