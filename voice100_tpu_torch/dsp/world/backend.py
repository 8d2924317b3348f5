"""The WORLD analysis backends the port runs: the host's float64 NumPy.

The JAX package's analysis also runs on its device (``backend="jax"``:
``dio_jax``, ``_cheaptrick_jax``, ``_harmonic_jax``,
``_band_aperiodicity_jax``); the port's device analysis is not written
yet, so asking for any backend but ``"numpy"`` raises.
"""

from __future__ import annotations

__all__ = ["ANALYSIS_ITEM", "require_host_backend"]

ANALYSIS_ITEM = "ROADMAP.md queue 1, item 7: the device WORLD analysis"


def require_host_backend(backend: str) -> None:
    """Raise ``NotImplementedError`` unless ``backend`` is ``"numpy"``."""
    if backend != "numpy":
        raise NotImplementedError(f"WORLD analysis backend {backend!r}: only the host's "
                                  f"'numpy' is ported ({ANALYSIS_ITEM})")
