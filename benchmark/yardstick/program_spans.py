"""The program's own spans and counters: the table that
``voice100_tpu_torch.utils.profiling`` keeps of its newest traced
session, which is the traced window when a metric reads it (the set-up's
steps and calls run untraced, so the window's first span starts the
session afresh).

Each reading is a sum over the window divided by the calls of a root span
(``trainer.train_step``, ``asr.transcribe``, or the batches taken,
``prefetch.prepare``), and None when the root has no calls: a program
without the table (before its spans existed) reads None, and raises
nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence


def table() -> Optional[dict]:
    """The program's table, or None when the program keeps none."""
    try:
        from voice100_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "table", None)
    return None if read is None else read()


def _calls(t: dict, root: str) -> int:
    return t["spans"].get(root, (0, 0.0))[0]


def span_ms(name: str, root: str) -> Optional[float]:
    """Milliseconds of span ``name`` in the window per call of ``root``."""
    t = table()
    if t is None or not _calls(t, root):
        return None
    return 1e3 * t["spans"].get(name, (0, 0.0))[1] / _calls(t, root)


def counted(names: Sequence[str], root: str) -> Optional[float]:
    """The counters ``names`` summed over the window per call of ``root``
    (a counter the program did not take reads 0: off a CUDA device)."""
    t = table()
    if t is None or not _calls(t, root):
        return None
    return sum(t["counters"].get(n, 0) for n in names) / _calls(t, root)
