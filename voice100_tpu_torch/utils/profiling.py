"""Profiling and timing (port of ``voice100_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace (the host's activity
and, on a CUDA device, the card's kernels, copies and memsets) and
writes it as a Chrome trace (``chrome://tracing``, Perfetto) into a
directory; :class:`Timer` is a wall-clock timer that waits for the card
before it stops; :func:`realtime_factor` gives audio seconds a second.

The program's own spans and counters live here too. :func:`span` marks a
phase of the host's work (the trainer's step, the prefetcher, the ASR
pipeline). Tracing is on exactly while a ``torch.profiler`` session
records on the calling thread (:func:`trace`, the trainer's
``profile_dir``, or any caller's ``torch.profiler.profile``); there is no
other switch. When it is off a span costs the check of the thread's
profiler flag (and a thread-local mark that spans ran untraced): no range
and no clock read. When it is on a span opens a range ``v100.<name>`` in
the profiler's trace, on the kernels' clock, recorded as a ``cpu_op``
(``_RecordFunctionFast``), so the card's timeline gets no copy of it
(``record_function`` ranges are copied onto the card as
``gpu_user_annotation``); it also adds one call and its wall seconds to
an in-process table, which :func:`table` reads with the counters of
:func:`count`. The table holds the newest traced session: :func:`trace`
starts a fresh one, and so does the first traced span on a thread whose
spans ran untraced before (a counter starts none). Updates are
thread-safe.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..device import resolve_device

__all__ = ["trace", "Timer", "device_sync", "realtime_factor", "span", "count", "charge",
           "table", "SPAN_PREFIX"]

SPAN_PREFIX = "v100."

# looked up once: the profiler flag of the calling thread, and the range
# that the profiler records as a cpu_op
_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter


class _Table:
    """Calls and seconds by span name and sums by counter name, for the
    newest traced session."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # per thread: whether its spans ran untraced since its last traced one
        self.thread = threading.local()
        self._spans: Dict[str, list] = {}
        self._counters: Dict[str, float] = {}

    def begin_traced(self) -> None:
        """Start a fresh session if this thread's spans ran untraced (or
        none ran) since its last traced one."""
        if getattr(self.thread, "untraced", True):
            self.start()

    def start(self) -> None:
        """A fresh session, begun by the calling thread."""
        self.thread.untraced = False
        with self._lock:
            self._spans, self._counters = {}, {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            row = self._spans.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += seconds

    def count(self, name: str, n: float) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def read(self) -> Dict[str, dict]:
        with self._lock:
            return {"spans": {k: (c, s) for k, (c, s) in self._spans.items()},
                    "counters": dict(self._counters)}


_TABLE = _Table()
_THREAD = _TABLE.thread
_OFF = contextlib.nullcontext()  # the span when tracing is off


def _allocator_calls(device: torch.device) -> Tuple[int, int]:
    # the nested form: memory_stats() flattens every statistic in Python
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return int(stats.get("num_device_alloc", 0)), int(stats.get("num_device_free", 0))


class _Span:
    """A traced span: the profiler's range, the wall clock and, on a CUDA
    device, the caching allocator's device allocations and frees."""

    __slots__ = ("name", "device", "_range", "_t0", "_alloc0")

    def __init__(self, name: str, device) -> None:
        self.name = name
        if isinstance(device, torch.nn.Module):
            device = next(device.parameters()).device
        self.device = (device if isinstance(device, torch.device) and device.type == "cuda"
                       else None)

    def __enter__(self) -> None:
        _TABLE.begin_traced()
        if self.device is not None:
            self._alloc0 = _allocator_calls(self.device)
        self._range = _Range(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self._t0 = _clock()

    def __exit__(self, *exc) -> None:
        seconds = _clock() - self._t0
        self._range.__exit__(*exc)
        _TABLE.add(self.name, seconds)
        if self.device is not None:
            alloc, free = _allocator_calls(self.device)
            count("allocator.device_alloc", alloc - self._alloc0[0])
            count("allocator.device_free", free - self._alloc0[1])


def span(name: str, device=None):
    """A context manager over one phase of the host's work: when tracing
    is on, a ``v100.<name>`` range in the trace and one call with its
    wall seconds in :func:`table`. With ``device`` a CUDA device (or a
    module on one: its first parameter's device, looked up only when
    tracing is on) the caching allocator's device allocations and frees
    across the span are added to the counters ``allocator.device_alloc``
    and ``allocator.device_free``: a ``cudaFree`` waits for the card."""
    if _enabled():
        return _Span(name, device)
    _THREAD.untraced = True
    return _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` of :func:`table` when tracing is on.
    A counter joins the session and starts none: it may be taken on a
    thread that runs no span (autograd's backward thread on a card), whose
    first traced call would otherwise drop what the session held."""
    if _enabled():
        _TABLE.count(name, n)


def charge(name: str, seconds: float) -> None:
    """Add one call of ``seconds`` to span ``name`` of :func:`table` when
    tracing is on, with no range: for work timed on a thread the profiler
    does not record (the prefetcher's), charged by the thread that uses
    it."""
    if _enabled():
        _TABLE.begin_traced()
        _TABLE.add(name, seconds)


def table() -> Dict[str, dict]:
    """The newest traced session: ``{"spans": {name: (calls, seconds)},
    "counters": {name: sum}}`` (names without the ``v100.`` prefix)."""
    return _TABLE.read()


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block on ``device``
    (default ``cuda``, which raises without CUDA; ``cpu`` records the host
    only). On leaving, also by an exception, the card is synchronised and
    the trace written to ``log_dir/<host>.<pid>.<ms>.pt.trace.json``
    (the name ``tensorboard_trace_handler`` gives); the profiler is
    yielded, and its ``trace_path`` names the file once written. The
    block's spans (:func:`span`) are its ``v100.*`` ranges, and
    :func:`table` reads them from the start of the block."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    prof.start()
    _TABLE.start()  # a fresh session of spans and counters
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
