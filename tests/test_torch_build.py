"""The port's kernel build (``voice100_tpu_torch/kernels/build.py``), CPU.

A library's name carries a hash of its ``.cu`` source and of every header
of ``csrc/`` that source includes, so editing a shared header such as
``bilstm_persistent.cuh`` rebuilds every library that includes it, and no
other. The module imports and names its libraries without nvcc; only a
build needs it. The step probe (``tools/probe_bilstm.py``) finds its text
anchors in the committed kernels.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from voice100_tpu_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_sources_list_the_included_headers(csrc):
    names = {name: [p.name for p in build.sources(name)] for name in build.KERNELS}
    assert names["bilstm"] == ["bilstm.cu", "bilstm_persistent.cuh"]
    assert names["bilstm_train"] == ["bilstm_train.cu", "bilstm_persistent.cuh"]
    for name in ("melspec", "ctc", "viterbi"):
        assert names[name] == [f"{name}.cu"]


def test_editing_a_header_renames_exactly_the_libraries_that_include_it(csrc):
    before = {name: build.library_path(name) for name in build.KERNELS}
    header = csrc / "bilstm_persistent.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {name: build.library_path(name) for name in build.KERNELS}
    for name in build.KERNELS:
        changed = name in ("bilstm", "bilstm_train")
        assert (after[name] != before[name]) == changed, name
        assert after[name].parent == build.BUILD_DIR


def test_headers_included_through_a_header_count_too(csrc):
    (csrc / "probe.cu").write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n')
    (csrc / "outer.cuh").write_text('#pragma once\n  #  include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// v1\n")
    assert [p.name for p in build.sources("probe")] == ["probe.cu", "outer.cuh", "inner.cuh"]
    first = build.library_path("probe")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert build.library_path("probe") != first


def test_build_module_imports_and_names_libraries_without_nvcc(tmp_path):
    code = (
        "from voice100_tpu_torch.kernels import build\n"
        "paths = [build.library_path(n).name for n in build.KERNELS]\n"
        "try:\n"
        "    build._nvcc()\n"
        "except RuntimeError as err:\n"
        "    print('no nvcc:', err)\n"
        "print(len(paths), paths[1])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_HOME": str(tmp_path / "none"),
           "PATH": str(tmp_path)}
    env.pop("CUDA_PATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no nvcc: nvcc not found" in out.stdout
    assert out.stdout.strip().endswith(".so") and "5 libbilstm-" in out.stdout


@pytest.mark.parametrize("kind,source", [("forward", "bilstm_persistent.cuh"),
                                         ("backward", "bilstm_train.cu")])
def test_probe_anchors_are_found_in_the_committed_kernels(kind, source):
    """The step probe cuts parts of a kernel by text anchors: each anchor
    must occur once, and every variant must differ from the kernel."""
    from voice100_tpu_torch.tools import probe_bilstm

    variants = getattr(probe_bilstm, f"{kind}_variants")((build.CSRC / source).read_text())
    assert "full" in variants and len(variants) >= 6
    assert all(text != variants["full"] for name, text in variants.items() if name != "full")


@pytest.mark.parametrize("kind,source", [("ctc", "ctc.cu"), ("viterbi", "viterbi.cu")])
def test_ctc_probe_anchors_are_found_in_the_committed_kernels(kind, source):
    """The CTC step probe cuts parts of kernels 4-7 by text anchors: each
    anchor must occur once, every variant must differ from the kernel, and
    a cut may not leave a loop whose body is the barrier after it."""
    from voice100_tpu_torch.tools import probe_ctc

    variants = getattr(probe_ctc, f"{kind}_variants")((build.CSRC / source).read_text())
    assert "full" in variants and len(variants) >= 3
    assert all(text != variants["full"] for name, text in variants.items() if name != "full")
    for name, text in variants.items():
        assert not re.search(r"\)\s*\n\s*__syncthreads\(\);", text), name
