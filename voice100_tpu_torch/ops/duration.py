"""Duration expansion: text + per-token durations -> aligned text.

Port of ``voice100_tpu/ops/duration.py``. The reference's cursor
(``_spans_v2``, a ``lax.scan`` over tokens) runs on the host, in float32
numpy, after the fetch of the durations that the caller makes anyway to
size the output: its adds must come in the scan's order, since ``floor``
of a differently rounded cursor moves a frame, and a host loop of
``2 L`` numpy adds over the batch costs well under a millisecond. The
expansion itself (``searchsorted`` over output positions) runs on the
device of ``text``.

Cursor (``voice100_tpu/ops/duration.py:23-37``), per token ``i`` with
durations ``(a_i0, a_i1)``: ``t += a_i0`` (not for the first token),
``s_i = max(floor(t), e_{i-1})``, ``t += a_i1``,
``e_i = max(floor(t), s_i + 1)``, from ``t = head``, ``e_{-1} = 0``.
Durations are ``exp(y) - 1`` and may be negative; the ``max`` rule keeps
the spans ordered and non-empty.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["duration_spans", "expand_alignment_batch", "aligntext_length"]


def duration_spans(align: np.ndarray, head: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """``align [B, L, 2]`` float32 -> per-token ``[start, end)`` spans,
    each ``[B, L]`` int32, by the reference cursor (float32 adds in the
    scan's order)."""
    align = np.asarray(align, np.float32)
    batch, length, _ = align.shape
    t = np.full(batch, head, np.float32)
    e = np.zeros(batch, np.int32)
    starts = np.empty((batch, length), np.int32)
    ends = np.empty((batch, length), np.int32)
    for i in range(length):
        if i:
            t = t + align[:, i, 0]
        s = np.maximum(np.floor(t).astype(np.int32), e)
        t = t + align[:, i, 1]
        e = np.maximum(np.floor(t).astype(np.int32), s + 1)
        starts[:, i], ends[:, i] = s, e
    return starts, ends


def aligntext_length(align: np.ndarray, head: int = 5, tail: int = 5) -> int:
    """Output length of one utterance: ``head + tail + trunc(sum(align) -
    align[0, 0])`` (``voice100_tpu/ops/duration.py:40-45``)."""
    align = np.asarray(align, np.float32)
    total = np.float32(align.sum(dtype=np.float32) - align[0, 0])
    return int(head + tail + int(total))


def expand_alignment_batch(text: torch.Tensor, align: np.ndarray, text_len, out_len: int,
                           head: int = 5, tail: int = 5,
                           blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand a padded batch: ``text [B, L]`` ids (a tensor, on the device
    the result takes), ``align [B, L, 2]`` host durations, ``text_len [B]``
    -> aligned ids ``[B, out_len]`` (``blank`` between and after the spans)
    and lengths ``[B]`` int32, both on ``text``'s device.

    Padded tokens get empty spans past the output (``out_len + 1``); a
    length is ``head + tail`` plus the float32 total of the valid
    durations less ``align[:, 0, 0]``, truncated, and capped at
    ``out_len`` (``voice100_tpu/ops/duration.py:94-103``)."""
    align = np.asarray(align, np.float32)
    lengths_host = (text_len.cpu().numpy() if isinstance(text_len, torch.Tensor)
                    else np.asarray(text_len))
    batch, length = align.shape[:2]
    starts, ends = duration_spans(align, head)
    valid = np.arange(length)[None, :] < lengths_host[:, None]
    big = np.int32(out_len + 1)
    starts = np.where(valid, starts, big)
    ends = np.where(valid, ends, big)
    totals = (align * valid[:, :, None].astype(np.float32)).sum(axis=(1, 2), dtype=np.float32)
    totals = totals - align[:, 0, 0]
    lengths = np.minimum(head + tail + totals.astype(np.int32), out_len).astype(np.int32)

    device = text.device
    starts_t = torch.from_numpy(starts).to(device)
    ends_t = torch.from_numpy(ends).to(device)
    pos = torch.arange(out_len, dtype=torch.int32, device=device).expand(batch, out_len)
    # spans are ordered and disjoint: the covering token is the last start <= pos
    idx = torch.searchsorted(starts_t, pos.contiguous(), right=True, out_int32=True) - 1
    idx = idx.clamp(0, length - 1).long()
    covered = (pos >= starts_t.gather(1, idx)) & (pos < ends_t.gather(1, idx))
    expanded = torch.where(covered, text.gather(1, idx).to(torch.int32), blank)
    return expanded, torch.from_numpy(lengths).to(device)
