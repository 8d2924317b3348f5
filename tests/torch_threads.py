"""Torch's CPU threads for the port's tests: one share of the cores each.

Every ``tests/test_torch_*.py`` imports this module before anything else.
Under pytest-xdist each worker process would otherwise start as many
intra-op threads as the machine has cores, so N workers run N times the
cores' threads and every small op waits on the others. This sets
``torch.set_num_threads(cpu_count // workers)`` (at least 1), with
``workers`` from ``PYTEST_XDIST_WORKER_COUNT`` (1 outside xdist), and
exports ``OMP_NUM_THREADS`` so that the subprocesses a test starts (the
CLI, spawned loader workers, distributed ranks) take the same share.
"""

import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)

torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
