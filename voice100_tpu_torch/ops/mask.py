"""Length masks and the blank-audio level, as serving needs them.

Port of ``voice100_tpu/ops/mask.py`` (``sequence_mask``, ``masked_mean``) and of the
``BLANK_AUDIO`` constant of ``voice100_tpu/ops/augment.py:30``
(augmentation itself is ``ops/augment.py``).
"""

from __future__ import annotations

import math

import torch

from .melspec import LOG_OFFSET

__all__ = ["BLANK_AUDIO", "sequence_mask", "masked_mean"]

# log-mel level of silence: padded frames are set to it
BLANK_AUDIO = math.log(LOG_OFFSET)


def sequence_mask(lengths: torch.Tensor, max_length: int, dtype=torch.float32) -> torch.Tensor:
    """``[B, T]`` mask with 1 where ``t < lengths[b]``."""
    t = torch.arange(max_length, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the positions where ``mask`` is 1; ``mask``
    broadcasts against ``x``, and the denominator is ``max(sum(mask), 1)``
    (the reference's masked loss reductions)."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)
