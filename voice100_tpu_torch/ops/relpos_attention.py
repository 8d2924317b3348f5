"""Relative-position multi-head attention (Transformer-XL, untied biases),
plain PyTorch: the Conformer's self-attention core.

Semantics of NeMo's ``RelPositionMultiHeadAttention`` after its
projections. With ``q, k, v`` of a head ``[T, D]``, its biases ``u`` and
``v_b`` ``[D]`` and the projected positions ``p [2T - 1, D]`` (row ``r``
holds relative position ``T - 1 - r``), the scores are

    s[i, j] = ((q_i + u) . k_j + (q_i + v_b) . p[T - 1 - i + j]) / sqrt(D)

that is, the positional term at relative position ``i - j`` (NeMo's
``rel_shift``). Pairs with a padded query or key are set to -10000
before the softmax and to 0 after it (a padded query row attends to
nothing); the probabilities are multiplied by a given keep mask over
``1 - dropout_p``, then by ``v``.

Layouts are the projections' own, so nothing is transposed around the
call: ``q, k, v [B, T, H, D]``, ``p [2T - 1, H, D]``, biases ``[H, D]``,
the output ``[B, T, H, D]``; the keep mask is ``[B, H, T, T]`` uint8
(1 keeps a pair), drawn by :func:`keep_mask`.

:func:`relpos_attention_plain` materialises the ``[B, H, T, T]`` scores
(two batched matmuls, the shift, the softmax, the mask). It is the plain
version of kernel 9 (``ops/relpos_attention_cuda.py``), whose wrapper
runs it for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["MASKED_SCORE", "keep_mask", "dropout_keep", "rel_shift", "relpos_attention_plain"]

MASKED_SCORE = -10000.0


def keep_mask(shape, p: float, generator: torch.Generator, device) -> torch.Tensor:
    """A dropout keep mask (uint8, 1 with probability ``1 - p``): one
    ``bernoulli_`` draw of the whole tensor from ``generator``. Every mask
    of the Conformer's step is drawn by this call, so a replay with the
    same generator state, shapes and order gives the same masks."""
    return torch.empty(shape, dtype=torch.uint8, device=device).bernoulli_(
        1.0 - p, generator=generator)


def dropout_keep(x: torch.Tensor, keep: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """``x`` with the dropped elements zeroed and the rest scaled by
    ``1 / (1 - p)``; ``x`` itself without a mask."""
    if keep is None:
        return x
    return x * keep * (1.0 / (1.0 - p))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """NeMo's ``rel_shift`` of ``[..., T, 2T - 1]`` positional scores: row
    ``i`` is moved left by ``T - 1 - i``, so that column ``j`` of the
    first ``T`` holds the score at position row ``T - 1 - i + j``."""
    *lead, t, pos = x.shape
    x = torch.nn.functional.pad(x, (1, 0)).view(*lead, pos + 1, t)
    return x[..., 1:, :].reshape(*lead, t, pos)[..., :t]


def _pair_mask(lengths: torch.Tensor, time: int) -> torch.Tensor:
    """``[B, 1, T, T]``: True where the query or the key is padded."""
    valid = torch.arange(time, device=lengths.device)[None, :] < lengths[:, None]
    return ~(valid[:, None, :, None] & valid[:, None, None, :])


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           p: torch.Tensor, pos_bias_u: torch.Tensor, pos_bias_v: torch.Tensor,
                           lengths: torch.Tensor, keep: Optional[torch.Tensor] = None,
                           dropout_p: float = 0.0) -> torch.Tensor:
    """Kernel 9's plain version: ``[B, T, H, D]`` attention output."""
    _, time, _, dim = q.shape
    qu = (q + pos_bias_u).transpose(1, 2)                       # [B, H, T, D]
    qv = (q + pos_bias_v).transpose(1, 2)
    ac = qu @ k.permute(0, 2, 3, 1)                             # [B, H, T, T]
    bd = rel_shift(qv @ p.permute(1, 2, 0))                     # [B, H, T, T]
    scores = (ac + bd) / math.sqrt(dim)
    mask = _pair_mask(lengths.to(q.device), time)
    scores = scores.masked_fill(mask, MASKED_SCORE)
    attn = torch.softmax(scores, dim=-1).masked_fill(mask, 0.0)
    attn = dropout_keep(attn, keep, dropout_p)
    return (attn @ v.transpose(1, 2)).transpose(1, 2)
