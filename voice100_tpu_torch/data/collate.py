"""Batch collation with bucketed padding.

Port of ``voice100_tpu/data/collate.py`` (the reference's collates,
voice100/data_modules.py:446-474,673-682). Batches are NumPy arrays:

* mel:        ``((audio [B, T, D], audio_len), (text [B, L], text_len))``
* world:      ``((f0 [B, T], f0_len, logspc [B, T, S], codeap [B, T, C]),
  (aligntext [B, L], aligntext_len))``
* text-align: ``((text [B, L], text_len), (align [B, A], align_len))``

Audio pads with ``BLANK_AUDIO`` (``log(1e-6)``), tokens with blank 0, the
WORLD streams and durations with 0. Each padded length rounds up to a
bucket multiple (``TIME_BUCKET`` frames, ``TEXT_BUCKET`` tokens, twice
that for durations; ``VOICE100_TPU_TIME_BUCKET`` and
``VOICE100_TPU_TEXT_BUCKET`` override them, read at call time), so batches
come in few shapes and equal the JAX package's byte for byte. Each
collate carries the JAX package's ``pad_values`` and ``var_specs``. The
multi-task WORLD batches (``use_target``) wait for the v1 models.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..ops.mask import BLANK_AUDIO

__all__ = ["pad_stack", "bucket_extent", "collate_audio_text", "collate_world_text",
           "collate_text_align", "get_collate_fn", "TIME_BUCKET", "TEXT_BUCKET", "V1_ITEM"]

V1_ITEM = "ROADMAP.md queue 1, item 9: the v1 models"

BLANK_IDX = 0
TIME_BUCKET = 64   # frames (mel 10 ms hop: 0.64 s granularity)
TEXT_BUCKET = 16   # tokens


def _env_bucket(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be a positive integer, got {raw!r}")
    if value <= 0:
        raise ValueError(f"{name} must be a positive integer, got {raw!r}")
    return value


def _time_bucket(override: int = None) -> int:
    return override if override is not None else _env_bucket("VOICE100_TPU_TIME_BUCKET",
                                                             TIME_BUCKET)


def _text_bucket(override: int = None) -> int:
    return override if override is not None else _env_bucket("VOICE100_TPU_TEXT_BUCKET",
                                                             TEXT_BUCKET)


def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def pad_stack(items: Sequence[np.ndarray], pad_value: float, bucket: int,
              dtype=None) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length arrays, padded to a bucketed max length;
    returns ``(stacked, lengths int32)``."""
    lengths = np.asarray([len(x) for x in items], dtype=np.int32)
    max_len = _bucket(int(lengths.max()), bucket)
    first = np.asarray(items[0])
    out = np.empty((len(items), max_len) + first.shape[1:], dtype=dtype or first.dtype)
    for i, x in enumerate(items):
        out[i, :len(x)] = x
        out[i, len(x):] = pad_value
    return out, lengths


def bucket_extent(kind: str, n: int) -> int:
    """The padded length a batch whose longest ``kind`` row (``time``,
    ``text`` or ``align``) is ``n`` collates to."""
    if kind == "time":
        return _bucket(n, _time_bucket())
    if kind == "text":
        return _bucket(n, _text_bucket())
    if kind == "align":
        return _bucket(n, 2 * _text_bucket())
    raise ValueError(f"unknown bucket kind {kind!r}")


def collate_audio_text(batch, time_bucket: int = None, text_bucket: int = None):
    """Mel-mode batches: ``((audio, audio_len), (text, text_len))``."""
    audio, audio_len = pad_stack([b[0] for b in batch], BLANK_AUDIO, _time_bucket(time_bucket))
    text, text_len = pad_stack([b[1] for b in batch], BLANK_IDX, _text_bucket(text_bucket))
    return (audio, audio_len), (text, text_len)


# per-leaf pad values in the batch's structure (length leaves never pad;
# 0 stands for them), and the variable-length leaves of the flattened
# batch: feature leaf -> (its length leaf, bucket kind)
collate_audio_text.pad_values = ((BLANK_AUDIO, 0), (BLANK_IDX, 0))
collate_audio_text.var_specs = {0: (1, "time"), 2: (3, "text")}


def collate_world_text(batch, time_bucket: int = None, text_bucket: int = None):
    """WORLD-mode batches: ``((f0, f0_len, logspc, codeap), (aligntext,
    aligntext_len))`` (reference generate_audio_text_align_batch,
    data_modules.py:458-474)."""
    time_bucket = _time_bucket(time_bucket)
    f0, f0_len = pad_stack([b[0][0] for b in batch], 0.0, time_bucket)
    spc, _ = pad_stack([b[0][1] for b in batch], 0.0, time_bucket)
    codeap, _ = pad_stack([b[0][2] for b in batch], 0.0, time_bucket)
    text, text_len = pad_stack([b[1] for b in batch], BLANK_IDX, _text_bucket(text_bucket))
    return (f0, f0_len, spc, codeap), (text, text_len)


collate_world_text.pad_values = ((0.0, 0, 0.0, 0.0), (BLANK_IDX, 0))
collate_world_text.var_specs = {0: (1, "time"), 2: (1, "time"), 3: (1, "time"), 4: (5, "text")}


def collate_text_align(batch, text_bucket: int = None):
    """Duration-model batches: ``((text, text_len), (align, align_len))``,
    the flat durations padded to twice the text bucket (reference
    generate_text_align_batch, data_modules.py:673-682)."""
    text_bucket = _text_bucket(text_bucket)
    text, text_len = pad_stack([b[0] for b in batch], BLANK_IDX, text_bucket)
    align, align_len = pad_stack([b[1] for b in batch], 0, 2 * text_bucket)
    return (text, text_len), (align, align_len)


collate_text_align.pad_values = ((BLANK_IDX, 0), (0, 0))
collate_text_align.var_specs = {0: (1, "text"), 2: (3, "align")}


def get_collate_fn(vocoder: str, use_target: bool = False):
    """Factory (reference voice100/data_modules.py:433-443)."""
    if vocoder == "mel":
        return collate_audio_text
    if vocoder in ("world", "world_mcep"):
        if use_target:
            raise NotImplementedError(f"vocoder {vocoder!r} with use_target: the multi-task "
                                      f"batches wait for the v1 models ({V1_ITEM})")
        return collate_world_text
    raise ValueError(f"Unknown vocoder {vocoder!r}")
