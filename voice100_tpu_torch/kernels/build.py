"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of its source, of every header of
``csrc/`` the source includes (directly or through another header) and
of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. Libraries go to
``voice100_tpu_torch/_build/`` (listed in ``.gitignore``) at first use.
Every C entry returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["KERNELS", "build", "load", "check", "library_path", "sources"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("melspec", "bilstm", "bilstm_train", "ctc", "viterbi")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    ``#include "..."``, directly or through another, in first-seen order."""
    seen: List[str] = []
    todo = [f"{name}.cu"]
    while todo:
        file = todo.pop(0)
        if file not in seen:
            seen.append(file)
            todo += _INCLUDE.findall((CSRC / file).read_text())
    return [CSRC / file for file in seen]


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds",
    "log"}}`` for the sources compiled (``log`` holds ptxas' register and
    shared-memory report). Raises ``RuntimeError`` if a build fails."""
    names = KERNELS if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, start) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - start, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed. Every library
    exports ``const char* error_string(int)``."""
    with _lock:
        if name not in _loaded:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if status != 0:
        message = lib.error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message}) at launch")
