"""Kernel 3b's recurrence launch (``csrc/bilstm_bwd_cluster.cuh``), CPU.

The bf16 training adjoint's recurrence runs on the card only; on the CPU
these tests hold the Python side of its launch: the cluster size, blocks,
clusters and shared memory a block that ``ops/lstm_cuda.py``
``bwd_cluster_plan`` computes, at the configs' widths and batches and at
the batch cap; that they follow the kernel header's own constants and
cluster rule; and that a shape the kernel cannot take raises before the
library is loaded or anything is launched. ``chip_smoke.py`` holds the
library's numbers to the same plan on the card, and 3b's dG to kernel 3's
float32 recurrence bit for bit. Every biLSTM wrapper holds one lock over
its residency check and its launches (two serving threads launch kernel 1
at different shapes).
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import contextlib
import re
import types

import pytest
import torch

from voice100_tpu_torch.kernels import build
from voice100_tpu_torch.ops import lstm_cuda
from voice100_tpu_torch.ops.lstm_cuda import bwd_cluster_batch_cap, bwd_cluster_plan

HEADER = build.CSRC / "bilstm_bwd_cluster.cuh"
OPT_IN = 232448  # shared memory a block can opt into on the H100


def _smem(batch, hidden):
    """The header's layout: 8 warps x 4 slots of 32 rows x 32 floats, W_hh's
    4H x 8 columns, the warps' sums of 32 rows x 8 units, 2 x 4 x 8
    mbarriers of 8 bytes, and a row's (dh, dc) carry and sorted length and
    row (2 x 8 floats, 2 ints)."""
    return (8 * 4 * 32 * 32 * 4 + 4 * hidden * 8 * 4 + 8 * 32 * 8 * 4 + 2 * 4 * 8 * 8
            + batch * (2 * 8 * 4 + 2 * 4))


# H: (cluster, batch cap); clusters of 8 up to 120 blocks (15 clusters of 8
# are resident on an H100 at one block an SM), else of 2
WIDTHS = {128: (8, 1059), 256: (8, 832), 512: (2, 376)}


@pytest.mark.parametrize("batch", [32, 64, 128, "cap"])
@pytest.mark.parametrize("hidden", list(WIDTHS))
def test_plan_at_the_configs_widths(hidden, batch):
    cluster, cap = WIDTHS[hidden]
    batch = cap if batch == "cap" else batch
    plan = bwd_cluster_plan(batch, hidden)
    blocks = 2 * hidden // 8
    assert plan == {"cluster": cluster, "blocks": blocks, "clusters": blocks // cluster,
                    "smem_bytes": _smem(batch, hidden)}
    assert plan["smem_bytes"] <= OPT_IN


def test_shared_memory_at_the_tts_training_batch():
    # the header's own figure, B=128, H=512
    assert bwd_cluster_plan(128, 512)["smem_bytes"] == 214528


@pytest.mark.parametrize("hidden", list(WIDTHS))
def test_batch_cap_is_the_last_batch_that_fits(hidden):
    cap = bwd_cluster_batch_cap(hidden)
    assert cap == WIDTHS[hidden][1]
    assert _smem(cap, hidden) <= OPT_IN < _smem(cap + 1, hidden)
    bwd_cluster_plan(cap, hidden)
    with pytest.raises(ValueError, match="shared memory"):
        bwd_cluster_plan(cap + 1, hidden)


@pytest.mark.parametrize("batch,hidden", [(8, 100), (8, 0), (0, 512), (-1, 128)])
def test_plan_raises_for_shapes_the_kernel_cannot_take(batch, hidden):
    with pytest.raises(ValueError):
        bwd_cluster_plan(batch, hidden)


def test_clusters_tile_each_direction():
    for hidden in range(32, 545, 32):
        plan = bwd_cluster_plan(8, hidden)
        per_direction = hidden // 8
        assert per_direction % plan["cluster"] == 0, hidden
        assert plan["clusters"] * plan["cluster"] == plan["blocks"] == 2 * per_direction
        assert plan["cluster"] == (2 if plan["blocks"] > 120 else
                                   8 if per_direction % 8 == 0 else 4), hidden


def test_plan_follows_the_kernel_header():
    """The wrapper's constants and cluster rule are the header's."""
    text = HEADER.read_text()
    const = {name: int(value) for name, value in
             re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert const["THREADS"] // 32 == lstm_cuda._BWD_WARPS
    assert (const["UNITS"], const["SLOTS"], const["PASS"], const["Q"]) == (
        lstm_cuda._UNITS, lstm_cuda._BWD_SLOTS, lstm_cuda._BWD_PASS, lstm_cuda._BWD_Q)
    assert "constexpr int RED_ROWS = PASS / 2;" in text
    assert "constexpr int SLOT_ROWS = PASS / 2;" in text
    rule = re.search(r"return per_direction <= (\d+) \? \(per_direction % (\d+) == 0 \? (\d+) : "
                     r"(\d+)\) : (\d+);", text)
    limit, modulus, big, mid, small = map(int, rule.groups())
    for hidden in range(32, 545, 32):
        pd = hidden // 8
        want = (big if pd % modulus == 0 else mid) if pd <= limit else small
        assert bwd_cluster_plan(8, hidden)["cluster"] == want, hidden


class _Loaded(Exception):
    pass


def _no_library():
    raise _Loaded("the kernel library was loaded")


@pytest.fixture
def meta_wrapper(monkeypatch):
    """``bilstm_train_bwd_cuda`` on meta tensors, the device check passed
    and the library's loader replaced by one that raises ``_Loaded``."""
    monkeypatch.setattr(lstm_cuda, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(lstm_cuda, "_train_lib", _no_library)

    def call(batch, hidden, dtype=torch.bfloat16, time_steps=3):
        meta = dict(device="meta", dtype=dtype)
        return lstm_cuda.bilstm_train_bwd_cuda(
            torch.empty(2, batch, time_steps, 4 * hidden, **meta),
            torch.empty(2, 4 * hidden, hidden, device="meta"),
            torch.full((batch,), time_steps, dtype=torch.int32),
            torch.empty(2, batch, time_steps, hidden, **meta),
            torch.empty(2, batch, time_steps, hidden, **meta),
            torch.empty(batch, time_steps, 2 * hidden, **meta))
    return call


def test_a_batch_past_the_cap_raises_before_anything_loads(meta_wrapper):
    before = (lstm_cuda.bilstm_train_bwd_cuda.launches,
              lstm_cuda.bilstm_train_bwd_cuda.launches_bf16)
    with pytest.raises(ValueError, match="shared memory"):
        meta_wrapper(bwd_cluster_batch_cap(512) + 1, 512)
    assert (lstm_cuda.bilstm_train_bwd_cuda.launches,
            lstm_cuda.bilstm_train_bwd_cuda.launches_bf16) == before


@pytest.mark.parametrize("batch", [64, 128])
def test_a_batch_that_fits_goes_on_to_the_library(meta_wrapper, batch):
    with pytest.raises(_Loaded):
        meta_wrapper(batch, 512)


def test_the_float32_variant_keeps_its_own_launch(meta_wrapper):
    """The plan belongs to the bf16 recurrence: a float32 batch past 3b's
    cap goes on to the library (kernel 3's own check decides there)."""
    with pytest.raises(_Loaded):
        meta_wrapper(bwd_cluster_batch_cap(512) + 1, 512, dtype=torch.float32)


class _RecordingLib:
    """A kernel library whose entries record whether the launch lock is held
    and succeed (a small shared memory, status 0)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, lstm_cuda._LAUNCH_LOCK.locked()))
            return 1024 if name.endswith("smem_bytes") else 0
        return entry


@pytest.mark.parametrize("launch", ["kernel 1", "kernel 2", "kernel 3", "kernel 3b"])
def test_each_check_and_launch_runs_under_the_launch_lock(monkeypatch, launch):
    """The residency check sets the kernel's shared-memory limit for its
    shape and the launch relies on it, so another thread's check must not
    come between them."""
    lib = _RecordingLib()
    monkeypatch.setattr(lstm_cuda, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(lstm_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(lstm_cuda, "_train_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    batch, time_steps, hidden = 4, 3, 64
    dtype = torch.bfloat16 if launch == "kernel 3b" else torch.float32
    meta = dict(device="meta", dtype=dtype)
    xg = torch.empty(2, batch, time_steps, 4 * hidden, **meta)
    w_hh = torch.empty(2, 4 * hidden, hidden, device="meta")
    lengths = torch.full((batch,), time_steps, dtype=torch.int32)
    state = torch.empty(2, batch, time_steps, hidden, **meta)
    dout = torch.empty(batch, time_steps, 2 * hidden, **meta)
    if launch in ("kernel 1", "kernel 2"):
        lstm_cuda._forward("t", xg, w_hh, lengths, save_states=launch == "kernel 2")
    else:
        lstm_cuda.bilstm_train_bwd_cuda(xg, w_hh, lengths, state, state, dout)
    assert lib.calls and all(held for _, held in lib.calls), lib.calls
    assert not lstm_cuda._LAUNCH_LOCK.locked()
