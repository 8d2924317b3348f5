"""Profiling and timing (port of ``voice100_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace (the host's activity
and, on a CUDA device, the card's kernels, copies and memsets) and
writes it as a Chrome trace (``chrome://tracing``, Perfetto) into a
directory; :class:`Timer` is a wall-clock timer that waits for the card
before it stops; :func:`realtime_factor` gives audio seconds a second.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch

from ..device import resolve_device

__all__ = ["trace", "Timer", "device_sync", "realtime_factor"]


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block on ``device``
    (default ``cuda``, which raises without CUDA; ``cpu`` records the host
    only). On leaving, also by an exception, the card is synchronised and
    the trace written to ``log_dir/<host>.<pid>.<ms>.pt.trace.json``
    (the name ``tensorboard_trace_handler`` gives); the profiler is
    yielded, and its ``trace_path`` names the file once written."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                     f"{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


def device_sync(*tensors) -> None:
    """Wait for the work feeding ``tensors`` on their CUDA devices (each
    device once); tensors on the CPU and other objects need no wait."""
    for device in {t.device for t in tensors
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock timer; :meth:`stop` waits for the given tensors first."""

    def __init__(self) -> None:
        self.elapsed: Optional[float] = None
        self._start: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self, *sync_tensors) -> float:
        device_sync(*sync_tensors)
        self.elapsed = time.perf_counter() - self._start
        return self.elapsed

    def __exit__(self, *exc) -> None:
        if self.elapsed is None:
            self.elapsed = time.perf_counter() - self._start


def realtime_factor(audio_seconds: float, wall_seconds: float) -> float:
    """Seconds of audio processed a wall second."""
    return audio_seconds / max(wall_seconds, 1e-9)
