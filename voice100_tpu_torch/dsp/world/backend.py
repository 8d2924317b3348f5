"""The WORLD analysis backends: ``"numpy"`` and ``"device"``.

* ``"numpy"``: the host analysis in float64 NumPy, the JAX package's
  default (``dio``, ``cheaptrick``, ``aperiodicity``);
* ``"device"``: torch float32 on the vocoder's device, the counterpart of
  the JAX package's ``backend="jax"`` (``dio_jax``, ``_cheaptrick_jax``,
  ``_harmonic_jax``, ``_band_aperiodicity_jax``). ``"jax"`` names it
  too, because ``VOICE100_TPU_WORLD_BACKEND=jax`` is the switch both
  packages read.

Any other name raises ``ValueError``; the JAX package runs its host path
for a name it does not know.

The device estimators take float32 tensors; :func:`uploader` casts host
inputs to float32, as the JAX package casts them, and :func:`const` puts
constant vectors made in float32 NumPy (correctly rounded, as XLA's
float32 arithmetic is) on a tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device

__all__ = ["HOST", "DEVICE", "analysis_backend", "uploader", "const"]

HOST = "numpy"
DEVICE = "device"
_NAMES = {"numpy": HOST, "device": DEVICE, "jax": DEVICE}


def analysis_backend(name: str) -> str:
    """``HOST`` or ``DEVICE``, the backend ``name`` selects."""
    try:
        return _NAMES[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown WORLD analysis backend {name!r}: use 'numpy', 'device' "
                         "or its alias 'jax'") from None


def uploader(device):
    """A function that puts a host array on ``device`` (default ``cuda``)
    as float32."""
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return up


def const(array, like: torch.Tensor) -> torch.Tensor:
    """``array`` on ``like``'s device, in its own dtype."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(like.device)
