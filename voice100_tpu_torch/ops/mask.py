"""Length masks and the blank-audio level, as serving needs them.

Port of ``voice100_tpu/ops/mask.py:16`` (``sequence_mask``) and of the
``BLANK_AUDIO`` constant of ``voice100_tpu/ops/augment.py:30``
(augmentation itself is ``ops/augment.py``).
"""

from __future__ import annotations

import math

import torch

from .melspec import LOG_OFFSET

__all__ = ["BLANK_AUDIO", "sequence_mask"]

# log-mel level of silence: padded frames are set to it
BLANK_AUDIO = math.log(LOG_OFFSET)


def sequence_mask(lengths: torch.Tensor, max_length: int, dtype=torch.float32) -> torch.Tensor:
    """``[B, T]`` mask with 1 where ``t < lengths[b]``."""
    t = torch.arange(max_length, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)
