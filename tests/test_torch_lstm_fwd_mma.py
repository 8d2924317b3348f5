"""Kernels 1b and 2b, the bf16 forward recurrences (``csrc/bilstm_fwd_mma.cuh``), CPU.

The kernel runs on the card only. On the CPU these tests hold two things.

The plan: the shared memory a block, the blocks and the exchange's rows
that ``ops/lstm_cuda.py`` ``fwd_mma_plan`` computes follow the kernel
header's own constants; the batch cap at H = 512, 256 and 128 is the
last batch that fits; a batch past it raises before the library is
loaded; the residency check and the launch run under the wrappers'
launch lock.

The split: the kernel's product ``h W_hh^T`` runs on tensor cores as
three bf16 products, ``h_hi W_hi + (h_hi W_lo + h_lo W_hi)`` with
``v = v_hi + v_lo`` (each half bf16, round to nearest) and float32 sums.
A torch emulation of that product, kept here (the port has no such
argument), is held

* to a float64 product within 2^-15 sum_k |h_k||w_k| (each dropped part,
  h_lo W_lo and the two split residues, is at most 2^-16 |h||w| a term,
  and the terms' errors do not all line up); a single bf16 product
  misses that bound, which is why the kernel splits;
* driving the recurrence, to the JAX Pallas kernels in interpret mode
  on the same inputs: ``_bilstm_pallas_impl`` with
  ``VOICE100_TPU_LSTM_XG_DTYPE=bfloat16`` (kernel 1b) and
  ``_lstm_train_fwd_pair`` with bf16 ``xg`` and states (kernel 2b):
  ``out`` within ``F32_ATOL`` = 1e-5, as ``tests/test_torch_bf16.py``
  holds the float32 twins, and the bf16 states within one bf16 step
  (a float32 value next to a rounding boundary may round either way).

``chip_smoke.py`` holds the kernel itself to the twins on the card.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import contextlib
import re
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.kernels import build
from voice100_tpu_torch.ops import lstm as tl
from voice100_tpu_torch.ops import lstm_cuda
from voice100_tpu_torch.ops.lstm_cuda import (bwd_cluster_batch_cap, fwd_mma_batch_cap,
                                              fwd_mma_plan)

HEADER = build.CSRC / "bilstm_fwd_mma.cuh"
OPT_IN = 232448  # shared memory a block can opt into on the H100
# H: the batch cap (91,136 B of shared memory at B=128, H=512)
CAPS = {512: 2090, 256: 2545, 128: 2773}
BATCH, TIME, HIDDEN, D_IN = 4, 12, 32, 24
F32_ATOL = 1e-5
CASES = {"ragged": [12, 9, 5, 1], "full": [12, 12, 12, 12], "empty_row": [12, 7, 0, 3]}


def header_constants() -> dict:
    """The header's namespace-level ``constexpr int`` constants, each
    evaluated in terms of the ones before it."""
    const = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", HEADER.read_text(), re.M):
        const[name] = int(eval(expr, {"__builtins__": {}}, dict(const)))
    return const


def header_smem(batch: int, hidden: int) -> int:
    """``fwd_mma::smem_bytes`` from the header's constants: W's fragments
    (``FRAG_WORDS`` uint4 a k tile), the warps' sums (``WARPS x 4 x 32``
    float4) and ``CELL_BYTES`` a row."""
    c = header_constants()
    return (hidden // c["TILE_K"] * c["FRAG_WORDS"] * 16 + c["WARPS"] * 4 * 32 * 16
            + batch * c["CELL_BYTES"])


def test_plan_follows_the_kernel_header():
    c = header_constants()
    assert c["THREADS"] // 32 == c["WARPS"] == lstm_cuda._MMA_WARPS
    assert c["UNITS"] == lstm_cuda._UNITS
    assert c["TILE_M"] == c["TILE_K"] == lstm_cuda._MMA_TILE
    assert c["FRAG_WORDS"] * 16 == lstm_cuda._MMA_FRAG_BYTES
    assert c["CELL_BYTES"] == lstm_cuda._MMA_ROW_BYTES
    for hidden in (128, 256, 512):
        for batch in (1, 8, 32, 64, 128, 376):
            assert fwd_mma_plan(batch, hidden)["smem_bytes"] == header_smem(batch, hidden)
    # the header's own figures
    text = " ".join(HEADER.read_text().split())
    assert "91,136 B at B = 128, H = 512" in text
    assert fwd_mma_plan(128, 512)["smem_bytes"] == 91136
    assert f"B <= {CAPS[512]} at H = 512" in text


@pytest.mark.parametrize("batch", [1, 17, 32, 64, 128, 376])
@pytest.mark.parametrize("hidden", list(CAPS))
def test_plan_at_the_configs_widths(hidden, batch):
    plan = fwd_mma_plan(batch, hidden)
    assert plan == {"blocks": 2 * hidden // 8, "smem_bytes": header_smem(batch, hidden),
                    "exchange_rows": -(-batch // 16) * 16}
    assert plan["exchange_rows"] % 16 == 0 and plan["exchange_rows"] - batch < 16


@pytest.mark.parametrize("hidden", list(CAPS))
def test_batch_cap_is_the_last_batch_that_fits(hidden):
    cap = fwd_mma_batch_cap(hidden)
    assert cap == CAPS[hidden]
    assert header_smem(cap, hidden) <= OPT_IN < header_smem(cap + 1, hidden)
    fwd_mma_plan(cap, hidden)
    with pytest.raises(ValueError, match=f"batch <= {cap}"):
        fwd_mma_plan(cap + 1, hidden)
    # no bf16 training batch that the backward (kernel 3b) takes is refused
    assert cap >= bwd_cluster_batch_cap(hidden)


@pytest.mark.parametrize("batch,hidden", [(8, 100), (8, 0), (0, 512), (-1, 128)])
def test_plan_raises_for_shapes_the_kernel_cannot_take(batch, hidden):
    with pytest.raises(ValueError):
        fwd_mma_plan(batch, hidden)


class _Loaded(Exception):
    pass


def _no_library():
    raise _Loaded("the kernel library was loaded")


def _meta_call(save_states, batch, hidden, time_steps=3):
    xg = torch.empty(2, batch, time_steps, 4 * hidden, device="meta", dtype=torch.bfloat16)
    w_hh = torch.empty(2, 4 * hidden, hidden, device="meta")
    lengths = torch.full((batch,), time_steps, dtype=torch.int32)
    if save_states:
        return lstm_cuda.bilstm_train_fwd_cuda(xg, w_hh, lengths)
    return lstm_cuda._forward("bilstm_cuda", xg, w_hh, lengths, save_states=False)


@pytest.fixture
def no_library(monkeypatch):
    """The device check passed and both libraries' loaders replaced by one
    that raises ``_Loaded``."""
    monkeypatch.setattr(lstm_cuda, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(lstm_cuda, "_lib", _no_library)
    monkeypatch.setattr(lstm_cuda, "_train_lib", _no_library)


@pytest.mark.parametrize("save_states", [False, True], ids=["kernel 1b", "kernel 2b"])
def test_a_batch_past_the_cap_raises_before_anything_loads(no_library, save_states):
    wrappers = (lstm_cuda.bilstm_cuda, lstm_cuda.bilstm_train_fwd_cuda)
    before = [(w.launches, w.launches_bf16) for w in wrappers]
    with pytest.raises(ValueError, match=f"batch <= {CAPS[512]}"):
        _meta_call(save_states, CAPS[512] + 1, 512)
    assert [(w.launches, w.launches_bf16) for w in wrappers] == before


@pytest.mark.parametrize("save_states", [False, True], ids=["kernel 1b", "kernel 2b"])
@pytest.mark.parametrize("batch", [64, 128, CAPS[512]])
def test_a_batch_that_fits_goes_on_to_the_library(no_library, save_states, batch):
    with pytest.raises(_Loaded):
        _meta_call(save_states, batch, 512)


def test_inference_checks_the_cap_before_the_projection(monkeypatch):
    """``bilstm_cuda`` in bf16 raises past the cap before its projection
    (a matmul launch) runs."""
    monkeypatch.setattr(lstm_cuda, "project_inputs", _no_library)
    monkeypatch.setattr(lstm_cuda, "_lib", _no_library)
    batch, hidden = CAPS[256] + 1, 256
    x = types.SimpleNamespace(device=torch.device("cuda"), shape=(batch, 2, 8),
                              dtype=torch.float32)
    weights = [types.SimpleNamespace(device=x.device, dtype=torch.float32, shape=shape,
                                     is_contiguous=lambda: True)
               for shape in ((2, 4 * hidden, 8), (2, 4 * hidden, hidden), (2, 4 * hidden))]
    lengths = types.SimpleNamespace(shape=(batch,))
    with pytest.raises(ValueError, match=f"batch <= {CAPS[256]}"):
        lstm_cuda.bilstm_cuda(*weights, x, lengths, compute_dtype=torch.bfloat16)


class _RecordingLib:
    """A kernel library whose entries record their names and whether the
    launch lock is held, and succeed (status 0)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, lstm_cuda._LAUNCH_LOCK.locked()))
            return 0
        return entry


@pytest.mark.parametrize("save_states", [False, True], ids=["kernel 1b", "kernel 2b"])
def test_check_and_launch_run_under_the_launch_lock(monkeypatch, save_states):
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
    _meta_call(save_states, 20, 64)
    prefix = "lstm_train_fwd" if save_states else "bilstm"
    assert [name for name, _ in lib.calls] == [f"{prefix}_check_bf16", f"{prefix}_bf16"]
    assert all(held for _, held in lib.calls), lib.calls
    assert not lstm_cuda._LAUNCH_LOCK.locked()


# ---- the three-term split, emulated ----

def halves(v: torch.Tensor):
    """``v = hi + lo + residue``, each half bf16 rounded to nearest even,
    returned widened to float32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def split_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w^T`` as the kernel's mma computes it: three products of bf16
    operands (exact in float32) summed in float32, the main term and the
    two small ones in accumulators of their own."""
    h_hi, h_lo = halves(h.float())
    w_hi, w_lo = halves(w.float())

    def mm(a, b):
        return torch.matmul(a, b.transpose(-1, -2))

    return mm(h_hi, w_hi) + (mm(h_hi, w_lo) + mm(h_lo, w_hi))


@pytest.mark.parametrize("k", [32, 128, 512])
def test_split_product_is_within_2e15_of_float64(k):
    rng = np.random.default_rng(k)
    h = torch.from_numpy(np.tanh(rng.normal(size=(64, k)) * 2).astype(np.float32))
    bound = 1.0 / np.sqrt(k)
    w = torch.from_numpy(rng.uniform(-bound, bound, (32, k)).astype(np.float32))
    exact = h.double() @ w.double().T
    scale = h.double().abs() @ w.double().abs().T  # sum_k |h_k||w_k|
    err = (split_product(h, w).double() - exact).abs()
    assert (err <= 2.0 ** -15 * scale).all(), (err / scale).max().item()
    # one bf16 product (h and W each rounded once) misses the bound
    single = (h.bfloat16().float() @ w.bfloat16().float().T).double()
    assert ((single - exact).abs() > 2.0 ** -15 * scale).any()


def emulated_forward(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """Kernels 1b and 2b on the CPU with the split product: ``xg [2, B, T,
    4H]`` bf16, ``w_hh [2, 4H, H]`` float32 -> ``out [B, T, 2H]`` float32
    and the pre-update ``h_prev, c_prev [2, B, T, H]`` in bf16 (source
    time), the kernel's cell in float32."""
    _, batch, time, gates4 = xg.shape
    hidden = gates4 // 4
    xg = xg.float()
    h = torch.zeros(2, batch, hidden)
    c = torch.zeros(2, batch, hidden)
    out = torch.zeros(batch, time, 2, hidden)
    h_prev = torch.zeros(2, batch, time, hidden)
    c_prev = torch.zeros(2, batch, time, hidden)
    for s in range(time):
        ts = (s, time - 1 - s)
        x = torch.stack([xg[0, :, ts[0]], xg[1, :, ts[1]]])
        gates = x + split_product(h, w_hh)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        for d in range(2):
            h_prev[d, :, ts[d]], c_prev[d, :, ts[d]] = h[d], c[d]
            v = (lengths > ts[d])[:, None]
            out[:, ts[d], d] = torch.where(v, h_new[d], 0.0)
            h[d] = torch.where(v, h_new[d], h[d])
            c[d] = torch.where(v, c_new[d], c[d])
    return (out.reshape(batch, time, 2 * hidden), h_prev.to(torch.bfloat16),
            c_prev.to(torch.bfloat16))


def _layer(case, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(HIDDEN)

    def draw(*shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    params = {d: {"w_ih": draw(4 * HIDDEN, D_IN), "w_hh": draw(4 * HIDDEN, HIDDEN),
                  "b_ih": draw(4 * HIDDEN), "b_hh": draw(4 * HIDDEN)} for d in ("fwd", "bwd")}
    x = rng.normal(size=(BATCH, TIME, D_IN)).astype(np.float32)
    stacked = tl.stack_directions({d: {k: torch.from_numpy(v) for k, v in p.items()}
                                   for d, p in params.items()})
    return params, x, np.asarray(CASES[case], np.int32), stacked


def assert_within_one_bf16_step(got: np.ndarray, want: np.ndarray, what: str) -> None:
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    excess = np.abs(got - want) - np.exp2(np.floor(np.log2(mag)) - 7)
    assert excess.max() <= 0, f"{what}: beyond one bf16 step by {excess.max():.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_split_recurrence_matches_the_pallas_inference_kernel_in_bf16(case, monkeypatch):
    """Kernel 1b: the float32 projection rounded to bf16, then the
    recurrence with the split product, against ``_bilstm_pallas_impl``."""

    from voice100_tpu.ops.lstm_pallas import _bilstm_pallas_impl

    monkeypatch.setenv("VOICE100_TPU_LSTM_XG_DTYPE", "bfloat16")
    params, x, lengths, (w_ih, w_hh, bias) = _layer(case)
    want = np.asarray(_bilstm_pallas_impl(jax.tree_util.tree_map(jnp.asarray, params),
                                          jnp.asarray(x), jnp.asarray(lengths), interpret=True))
    xg = tl.project_inputs(w_ih, bias, torch.from_numpy(x)).to(torch.bfloat16)
    out, _, _ = emulated_forward(xg, w_hh, torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_split_recurrence_matches_the_pallas_train_forward_in_bf16(case):
    """Kernel 2b: the same bf16 ``xg`` into the recurrence with the split
    product and into ``_lstm_train_fwd_pair`` (bf16 states)."""
    from voice100_tpu.ops import lstm_pallas as lp

    params, _, lengths, (_, w_hh, _) = _layer(case, seed=1)
    rng = np.random.default_rng(2)
    xg = torch.from_numpy(rng.normal(size=(2, BATCH, TIME, 4 * HIDDEN)).astype(np.float32))
    xg = xg.to(torch.bfloat16)
    xg_np = xg.float().numpy()
    xg_f = jnp.asarray(np.swapaxes(xg_np[0], 0, 1)).astype(jnp.bfloat16)        # [T, B, 4H]
    xg_b = jnp.asarray(np.swapaxes(xg_np[1], 0, 1)[::-1]).astype(jnp.bfloat16)  # reversed
    whh2 = jnp.stack([jnp.asarray(params[d]["w_hh"]).T for d in ("fwd", "bwd")])
    (out_f, hs_f, cs_f), (out_b, hs_b, cs_b) = lp._lstm_train_fwd_pair(
        xg_f, xg_b, whh2, jnp.asarray(lengths), block_t=lp._block_t_train(True, backward=False),
        state_dtype=jnp.bfloat16, interpret=True)

    def source_time(fwd, bwd):
        f32 = [np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in (fwd, bwd)]
        return np.stack([np.swapaxes(f32[0], 0, 1), np.swapaxes(f32[1][::-1], 0, 1)])

    out, h_prev, c_prev = emulated_forward(xg, w_hh, torch.from_numpy(lengths))
    want_out = source_time(out_f, out_b).transpose(1, 2, 0, 3).reshape(BATCH, TIME, 2 * HIDDEN)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=F32_ATOL)
    assert_within_one_bf16_step(h_prev.float().numpy(), source_time(hs_f, hs_b), "h_prev")
    assert_within_one_bf16_step(c_prev.float().numpy(), source_time(cs_f, cs_b), "c_prev")
