"""The traced window: ``torch.profiler`` over the window, the benchmark's
own host spans as ``record_function`` ranges, and the reductions the
per-layer metrics read (device time by kernel name, busy time, idle gaps
named by what the host was doing).

The port's kernels by name on the card (``chip_smoke.py``'s
``counted_kernels``, copied): ``bilstm_persistent_kernel`` is kernels 1
(inference) and 2 (training forward), ``lstm_train_bwd_`` kernel 3's gate
pass and recurrence, ``ctc_alpha_kernel`` and ``ctc_adjoint_kernel``
kernels 4 and 5, ``bilstm_fwd_mma_kernel`` kernels 1b and 2b.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"

KERNELS = {
    "bilstm_recurrence": ("bilstm_persistent_kernel", "bilstm_fwd_mma_kernel"),
    "bilstm_train_bwd": ("lstm_train_bwd_",),
    "ctc_alpha": ("ctc_alpha_kernel",),
    "ctc_adjoint": ("ctc_adjoint_kernel",),
}


class Spans:
    """Host spans of the benchmark's own calls: durations by name, and a
    ``record_function`` range of the same name when a trace is on."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function(SPAN_PREFIX + name) if self.traced
              else contextlib.nullcontext())
        with rf:
            start = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - start)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    gaps: List[Tuple[float, str]] = field(default_factory=list)  # the longest, named

    def kernel_time(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose names hold any of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def top_ops(self, n: int = 10):
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10):
        return sorted(self.gaps, key=lambda g: -g[0])[:n]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> Optional[TraceSummary]:
    """Reduce a finished ``torch.profiler.profile`` over one window span:
    the device's kernels, copies and memsets inside it, their union (busy
    time) and the gaps between, each gap named by the host span that
    covers most of it. None if the trace holds no window span."""
    from torch.autograd import DeviceType

    window = None
    device, host = [], []
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            # the card's copies of the host annotations are not device work
            if not evt.name.startswith(SPAN_PREFIX):
                device.append((start, end, evt.name))
        elif evt.name == WINDOW_SPAN:
            window = (start, end)
        elif evt.name.startswith(SPAN_PREFIX):
            host.append((start, end, evt.name[len(SPAN_PREFIX):]))
    if window is None:
        return None
    w0, w1 = window
    kernel_s: Dict[str, float] = defaultdict(float)
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernel_s[name] += (b - a) * 1e-6
            clipped.append((a, b))
    busy = _merge(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    spans = [(b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps = []
    for dur, a, b in sorted(spans, reverse=True)[:10]:
        best, best_name = 0.0, "untracked"
        for h0, h1, name in host:
            overlap = min(b, h1) - max(a, h0)
            if overlap > best:
                best, best_name = overlap, name
        gaps.append((dur * 1e-6, best_name))
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, kernel_s=dict(kernel_s),
                        gaps=gaps)


@contextlib.contextmanager
def maybe_profile(on: bool, device):
    """``torch.profiler`` over the block when ``on`` (the card's activity
    where the device is a card); yields the profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def breakdown(summary: TraceSummary) -> dict:
    """The ``breakdown`` of a traced result line: the device operations that
    took most time and the longest idle gaps by what the host was doing."""
    return {"device_ops": [[name[:160], s] for name, s in summary.top_ops()],
            "idle_gaps": [[name, s] for s, name in summary.top_gaps()]}
