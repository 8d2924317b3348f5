"""The check that a run loaded neither JAX nor the JAX package.

Modules are compared by their top-level name (the part before the first
dot) as a whole word: ``voice100_tpu_torch`` is the port and passes,
``voice100_tpu`` and ``voice100_tpu.models`` do not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "voice100_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), sorted."""
    names = sys.modules.keys() if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
