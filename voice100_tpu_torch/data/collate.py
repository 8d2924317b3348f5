"""Batch collation with bucketed padding.

Port of the mel path of ``voice100_tpu/data/collate.py`` (the reference's
generate_audio_text_batch, voice100/data_modules.py:446-455): batches are
``((audio [B, T, D], audio_len), (text [B, L], text_len))`` NumPy arrays,
audio padded with ``BLANK_AUDIO`` (``log(1e-6)``) and text with blank 0,
each padded length rounded up to a bucket multiple (``TIME_BUCKET`` frames,
``TEXT_BUCKET`` tokens; ``VOICE100_TPU_TIME_BUCKET`` and
``VOICE100_TPU_TEXT_BUCKET`` override them, read at call time), so batches
come in few shapes and equal the JAX package's byte for byte. The WORLD
collates wait for the TTS slice.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..ops.mask import BLANK_AUDIO

__all__ = ["pad_stack", "bucket_extent", "collate_audio_text", "get_collate_fn",
           "TIME_BUCKET", "TEXT_BUCKET"]

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
    """The padded length a batch whose longest ``kind`` row (``time`` or
    ``text``) is ``n`` collates to."""
    if kind == "time":
        return _bucket(n, _time_bucket())
    if kind == "text":
        return _bucket(n, _text_bucket())
    raise ValueError(f"unknown bucket kind {kind!r}")


def collate_audio_text(batch, time_bucket: int = None, text_bucket: int = None):
    """Mel-mode batches: ``((audio, audio_len), (text, text_len))``."""
    audio, audio_len = pad_stack([b[0] for b in batch], BLANK_AUDIO, _time_bucket(time_bucket))
    text, text_len = pad_stack([b[1] for b in batch], BLANK_IDX, _text_bucket(text_bucket))
    return (audio, audio_len), (text, text_len)


def get_collate_fn(vocoder: str):
    """Factory (reference voice100/data_modules.py:433-443); mel only."""
    if vocoder == "mel":
        return collate_audio_text
    if vocoder in ("world", "world_mcep"):
        raise NotImplementedError(f"vocoder {vocoder!r}: the WORLD collates wait for the TTS "
                                  f"slice of the port")
    raise ValueError(f"Unknown vocoder {vocoder!r}")
