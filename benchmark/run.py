"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window. The last line of standard output
is the result (one JSON object); the numbers that decide ``correct``
are printed beside their limits as the last lines of standard error and
under ``checks``, the result's last key. Without CUDA, with fewer cards
than the cell asks for, or when the run has loaded JAX or the JAX
package, it exits with another code than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    with open(BENCH_DIR.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"benchmark: {args.workload} needs {chips[args.workload]} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from yardstick import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_start=T_START, bench=bench)
    return harness.report(out)


if __name__ == "__main__":
    sys.exit(main())
