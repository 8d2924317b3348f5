"""WAV read/write (pure NumPy, no external audio deps).

A copy of ``voice100_tpu/dsp/wav.py``: the port imports nothing of the
JAX package. Replaces torchaudio.load/save as used by the reference
(voice100/data_modules.py:288, update_samples.py:90). Supports PCM
8/16/24/32-bit and float32/float64, mono or multichannel; reads return
float32 in [-1, 1].
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["read_wav", "parse_wav", "write_wav", "write_wav_bytes"]

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF WAV file -> (samples ``[channels, n]`` float32, rate)."""
    with open(path, "rb") as f:
        data = f.read()
    return parse_wav(data, name=path)


def parse_wav(
    data: bytes, name: str = "<bytes>", keep_int16: bool = False
) -> Tuple[np.ndarray, int]:
    """Parse in-memory RIFF WAV bytes (same contract as read_wav).

    ``keep_int16=True`` returns 16-bit PCM data as int16 samples
    without the float conversion (other formats still return float32)
    — serving paths can then upload the raw PCM to the device and
    normalize there at half the transfer bytes."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{name}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        audio_format = _WAVE_FORMAT_PCM  # subformat GUID: assume PCM
    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            if keep_int16:
                x = np.frombuffer(raw, dtype="<i2")
            else:
                x = (np.frombuffer(raw, dtype="<i2")
                     .astype(np.float32) / 32768.0)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{name}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{name}: unsupported WAV format {audio_format}")
    n = (len(x) // channels) * channels
    samples = x[:n].reshape(-1, channels).T
    return np.ascontiguousarray(samples), rate


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write PCM16 WAV; accepts float in [-1, 1] (``[n]`` or ``[ch, n]``)
    or int16."""
    with open(path, "wb") as f:
        f.write(write_wav_bytes(samples, rate))


def write_wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    """PCM16 WAV as bytes (same encoding as write_wav)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, n = samples.shape
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = np.round(samples * 32767.0).astype(np.int16)
    payload = samples.T.reshape(-1).astype("<i2").tobytes()
    byte_rate = rate * channels * 2
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, _WAVE_FORMAT_PCM, channels, rate, byte_rate,
        channels * 2, 16,
    )
    header += b"data" + struct.pack("<I", len(payload))
    return header + payload
