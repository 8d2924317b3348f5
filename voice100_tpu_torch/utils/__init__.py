"""Utilities: profiling, tracing and timing helpers."""

from .profiling import Timer, device_sync, realtime_factor, trace

__all__ = ["trace", "Timer", "device_sync", "realtime_factor"]
