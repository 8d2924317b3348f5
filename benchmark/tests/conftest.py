"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

CPU tests run the harness at tiny sizes on the port's plain path; tests
marked ``card`` need an NVIDIA card and skip without one (decided inside
the test, never at import)."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for path in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the card's TF32")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)
