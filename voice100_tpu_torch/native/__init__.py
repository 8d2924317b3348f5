"""Native (C++) audio library: FLAC and MP3 decode, resampling, batch
decode, WORLD synthesis.

Port of ``voice100_tpu/native/__init__.py``: ``audioio.cpp`` and
``world.cpp`` (copies of the JAX package's) build with ``g++ -O3 -shared
-fPIC -ldl`` into one shared library on first use and bind with ctypes.
The library goes to ``voice100_tpu_torch/_build/`` under a name that
carries a hash of both sources and the flags, as ``kernels/build.py`` names the CUDA libraries,
so an edited source is rebuilt and a stale library never loaded. The
build writes a temporary name and then renames it, so processes that
build at once never load a half-written library. MP3 decoding
``dlopen``s the system libmpg123 and the library loads without it.

A failed build raises :class:`NativeUnavailable` with g++'s stderr; WAV
decoding stays pure NumPy and needs none of this.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["get_lib", "library_path", "NativeUnavailable"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "audioio.cpp"
WORLD_SOURCE = Path(__file__).resolve().parent / "world.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LINK_FLAGS = ("-ldl",)

_LOCK = threading.Lock()
_LIB = None
_ERROR = None


class NativeUnavailable(ImportError):
    pass


def library_path() -> Path:
    digest = hashlib.sha1(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    for source in (SOURCE, WORLD_SOURCE):
        digest.update(source.name.encode() + b"\0" + source.read_bytes())
    return BUILD_DIR / f"libaudioio-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), str(WORLD_SOURCE), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailable(f"native build failed: {' '.join(cmd)}\n{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native audio library."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise _ERROR
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, NativeUnavailable) as e:
            _ERROR = NativeUnavailable(str(e))
            raise _ERROR
        lib.v100_read_flac.restype = ctypes.c_int
        lib.v100_read_flac.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.v100_resample.restype = ctypes.c_int
        lib.v100_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.v100_read_mp3.restype = ctypes.c_int
        lib.v100_read_mp3.argtypes = list(lib.v100_read_flac.argtypes)
        lib.v100_mp3_available.restype = ctypes.c_int
        lib.v100_mp3_available.argtypes = []
        lib.v100_read_audio.restype = ctypes.c_int
        lib.v100_read_audio.argtypes = list(lib.v100_read_flac.argtypes)
        lib.v100_read_audio_batch.restype = ctypes.c_int
        lib.v100_read_audio_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.v100_world_synthesize.restype = ctypes.c_int
        lib.v100_world_synthesize.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.v100_free.restype = None
        lib.v100_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
        return _LIB
