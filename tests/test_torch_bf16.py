"""The port's bf16 mixed-precision mode vs the JAX package's Pallas path (CPU).

The plain twins of kernels 1-3 in their bf16 mode
(``voice100_tpu_torch/ops/lstm.py``) are held against the Pallas kernels
themselves, run in interpret mode on the CPU as the JAX package runs
them there (``parallel/mesh.py`` ``pallas_interpret``): kernel 1 through
``_bilstm_pallas_impl`` with ``VOICE100_TPU_LSTM_XG_DTYPE=bfloat16``,
kernels 2 and 3 through ``_bilstm_op``'s forward and backward with its
``bf16`` flag on. The weights are stacked with ``stack_directions``; the
JAX side's backward-direction arrays, kept reversed in time, are put
back in source time before the comparison.

Tolerances. Both sides round at the same points (the bf16 projection,
the saved states, ``dout``, dG), and the float32 sums between them run in
another order, so a rounded value may land one bf16 step away where the
float32 value lies next to a rounding boundary:

* a bf16 value (``xg``, the saved states, dG): within one bf16 ulp of
  the JAX value (``BF16_ULPS = 1``, the ulp of each JAX element);
* a float32 value (outputs, the weight and input gradients): 1e-5
  absolute (measured 1.1e-6 at most: an ulp of ``xg`` moves ``out``
  by about that much);
* the bf16 mode against the float32 one, JAX's own check
  (``tests/test_ops_parity.py:412-440``): rtol 0.1, atol 0.02.

``ConvLayerBlock`` under the bf16 mode is held to flax's block under
``set_default_compute_dtype(jnp.bfloat16)``: its convolution's result and
the bias sum are rounded to bf16, then LayerNorm and GELU run in float32,
so the output may differ where a conv value lands one bf16 step away
and the LayerNorm carries that step through its 1/std: 1e-2 absolute
against outputs of unit scale (about one bf16 ulp at 1); measured
7.2e-7, the float32 LayerNorm's order alone.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.models.layers import ConvLayerBlock, ConvTransposeLayerBlock
from voice100_tpu_torch.ops import lstm as tl
from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                              bilstm_train_cuda, bilstm_train_fwd_cuda)

BATCH, TIME, HIDDEN, D_IN = 4, 12, 32, 24
BF16_ULPS = 1
F32_ATOL = 1e-5
CONV_ATOL = 1e-2
CASES = {"ragged": [12, 9, 5, 1], "full": [12, 12, 12, 12], "empty_row": [12, 7, 0, 3]}


def bf16_ulp(values: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at each element's magnitude (8 bits of
    mantissa); the least normal spacing at 0."""
    mag = np.maximum(np.abs(np.asarray(values, np.float32)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_within_bf16_ulps(got: np.ndarray, want: np.ndarray, what: str) -> None:
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    excess = err - BF16_ULPS * bf16_ulp(want)
    assert excess.max() <= 0, f"{what}: {err.max():.3e} beyond {BF16_ULPS} bf16 ulp"


@pytest.fixture(autouse=True)
def _xg_streams_bf16(monkeypatch):
    """The JAX inference kernel's bf16 stream (its default, pinned here),
    and the port's mode off unless a test sets it."""
    monkeypatch.setenv("VOICE100_TPU_LSTM_XG_DTYPE", "bfloat16")
    monkeypatch.delenv("VOICE100_TPU_MATMUL_DTYPE", raising=False)
    tl.set_default_compute_dtype(None)
    yield
    tl.set_default_compute_dtype(None)


def _layer(case, seed=0):
    """One layer's weights (torch layout), input, lengths and a cotangent,
    from numpy; the JAX params and the port's stacked weights."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(HIDDEN)

    def draw(*shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    params = {d: {"w_ih": draw(4 * HIDDEN, D_IN), "w_hh": draw(4 * HIDDEN, HIDDEN),
                  "b_ih": draw(4 * HIDDEN), "b_hh": draw(4 * HIDDEN)} for d in ("fwd", "bwd")}
    x = rng.normal(size=(BATCH, TIME, D_IN)).astype(np.float32)
    lengths = np.asarray(CASES[case], np.int32)
    g = rng.normal(size=(BATCH, TIME, 2 * HIDDEN)).astype(np.float32)
    stacked = tl.stack_directions({d: {k: torch.from_numpy(v) for k, v in p.items()}
                                   for d, p in params.items()})
    return params, x, lengths, g, stacked


def _source_time(fwd, bwd) -> np.ndarray:
    """JAX's per-direction ``[T, B, *]`` arrays (the backward one reversed
    in time) -> the port's ``[2, B, T, *]`` in source time, float32."""
    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    return np.stack([np.swapaxes(f32(fwd), 0, 1), np.swapaxes(f32(bwd)[::-1], 0, 1)])


def _jax_train(params, x, lengths, g):
    """``_bilstm_op(True, ...)``'s forward residuals, the dG of its
    backward kernel and its gradients."""
    from voice100_tpu.ops import lstm_pallas as lp

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out, residuals = lp._bilstm_op_fwd(True, jp, jnp.asarray(x), jnp.asarray(lengths))
    _, _, _, states, xg_f, xg_b = residuals
    dout_f = jnp.swapaxes(jnp.asarray(g)[..., :HIDDEN], 0, 1).astype(jnp.bfloat16)
    dout_b = jnp.swapaxes(jnp.asarray(g)[..., HIDDEN:], 0, 1)[::-1].astype(jnp.bfloat16)
    dg = lp._lstm_train_bwd_pair(xg_f, xg_b, lp._stack_whh(jp), jnp.asarray(lengths), states,
                                 dout_f, dout_b, block_t=lp._block_t_train(True, backward=True),
                                 interpret=True)

    def loss(p, xx):
        return jnp.sum(lp._bilstm_op(True, p, xx, jnp.asarray(lengths)) * jnp.asarray(g))

    grads = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return {"out": np.asarray(out), "xg": _source_time(xg_f, xg_b),
            "h_prev": _source_time(states["fwd"][0], states["bwd"][0]),
            "c_prev": _source_time(states["fwd"][1], states["bwd"][1]),
            "dg": _source_time(*dg), "grads": grads}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel1_twin_matches_the_pallas_inference_kernel_in_bf16(case):
    """Kernel 1's bf16 mode: the float32 projection rounded to bf16, a
    float32 recurrence (``lstm_pallas.py:131-146``)."""
    from voice100_tpu.ops.lstm_pallas import _bilstm_pallas_impl

    params, x, lengths, _, (w_ih, w_hh, bias) = _layer(case)
    want = np.asarray(_bilstm_pallas_impl(jax.tree_util.tree_map(jnp.asarray, params),
                                          jnp.asarray(x), jnp.asarray(lengths), interpret=True))
    args = (w_ih, w_hh, bias, torch.from_numpy(x), torch.from_numpy(lengths))
    got = tl.bilstm(*args, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    # the wrapper runs the same twin for CPU tensors
    before = bilstm_cuda.launches + bilstm_cuda.launches_bf16
    assert torch.equal(bilstm_cuda(*args, compute_dtype=torch.bfloat16), got)
    assert bilstm_cuda.launches + bilstm_cuda.launches_bf16 == before


@pytest.mark.parametrize("case", list(CASES))
def test_kernel2_twin_matches_the_pallas_train_forward_in_bf16(case):
    """Kernel 2's bf16 mode: the bf16-operand projection, a bf16 ``xg``
    in, float32 ``out`` and the pre-update states saved in bf16."""
    params, x, lengths, g, (w_ih, w_hh, bias) = _layer(case)
    want = _jax_train(params, x, lengths, g)
    xg = tl.project_inputs(w_ih, bias, torch.from_numpy(x), torch.bfloat16)
    assert xg.dtype == torch.bfloat16
    assert_within_bf16_ulps(xg.float().numpy(), want["xg"], "xg")
    out, h_prev, c_prev = bilstm_train_fwd_cuda(xg, w_hh, torch.from_numpy(lengths))
    assert out.dtype == torch.float32 and h_prev.dtype == c_prev.dtype == torch.bfloat16
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=0, atol=F32_ATOL)
    assert_within_bf16_ulps(h_prev.float().numpy(), want["h_prev"], "h_prev")
    assert_within_bf16_ulps(c_prev.float().numpy(), want["c_prev"], "c_prev")


@pytest.mark.parametrize("case", list(CASES))
def test_kernel3_twin_matches_the_pallas_train_backward_in_bf16(case):
    """Kernel 3's bf16 mode on JAX's own saved residuals (bf16 ``xg`` and
    states) and a bf16 ``dout``: float32 gates and carries, dG rounded to
    bf16 only where it is stored."""
    params, x, lengths, g, (_, w_hh, _) = _layer(case)
    want = _jax_train(params, x, lengths, g)
    bf16 = [torch.from_numpy(want[k]).to(torch.bfloat16) for k in ("xg", "h_prev", "c_prev")]
    dout = torch.from_numpy(g).to(torch.bfloat16)
    dg = bilstm_train_bwd_cuda(bf16[0], w_hh, torch.from_numpy(lengths), *bf16[1:], dout)
    assert dg.dtype == torch.bfloat16
    assert_within_bf16_ulps(dg.float().numpy(), want["dg"], "dG")
    # frozen steps carry no gradient
    t = np.arange(TIME)
    assert not dg.float().numpy()[:, t[None, :] >= lengths[:, None]].any()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_function_gradients_match_jax_grad(case):
    """``BiLSTMFunction`` in bf16 against ``jax.grad`` of ``_bilstm_op(True,
    ...)``: dW_ih, dW_hh and dx are products of bf16 operands with float32
    results, db the float32 sum of the bf16 dG."""
    params, x, lengths, g, stacked = _layer(case)
    want = _jax_train(params, x, lengths, g)
    leaves = [t.clone().requires_grad_() for t in (*stacked, torch.from_numpy(x))]
    out = bilstm_train_cuda(*leaves, torch.from_numpy(lengths), compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(out.detach().numpy(), want["out"], rtol=0, atol=F32_ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    d_params, d_x = want["grads"]
    for i, name in enumerate(("w_ih", "w_hh")):
        np.testing.assert_allclose(
            leaves[i].grad.numpy(),
            np.stack([d_params["fwd"][name], d_params["bwd"][name]]),
            rtol=0, atol=F32_ATOL, err_msg=name)
    for direction, row in (("fwd", 0), ("bwd", 1)):
        for name in ("b_ih", "b_hh"):  # both biases get sum dG
            np.testing.assert_allclose(leaves[2].grad.numpy()[row], d_params[direction][name],
                                       rtol=0, atol=F32_ATOL, err_msg=f"{direction}.{name}")
    np.testing.assert_allclose(leaves[3].grad.numpy(), np.asarray(d_x), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_mode_stays_close_to_float32_by_jax_rule(case):
    """JAX's own check of its bf16 path against float32
    (``tests/test_ops_parity.py:412-440``), on the port: rtol 0.1, atol
    0.02, for the outputs and every gradient."""
    _, x, lengths, g, stacked = _layer(case, seed=1)
    results = []
    for dtype in (None, torch.bfloat16):
        leaves = [t.clone().requires_grad_() for t in (*stacked, torch.from_numpy(x))]
        out = bilstm_train_cuda(*leaves, torch.from_numpy(lengths), compute_dtype=dtype)
        (out * torch.from_numpy(g)).sum().backward()
        results.append([out.detach()] + [t.grad for t in leaves])
    for name, f32, bf16 in zip(("out", "w_ih", "w_hh", "bias", "x"), *results):
        np.testing.assert_allclose(bf16.numpy(), f32.numpy(), rtol=0.1, atol=0.02, err_msg=name)


def test_default_compute_dtype_follows_the_process_default_then_the_env(monkeypatch):
    """``set_default_compute_dtype`` first, then
    ``VOICE100_TPU_MATMUL_DTYPE=bfloat16``, as the JAX package reads them
    (``voice100_tpu/ops/lstm.py:40-62``)."""
    from voice100_tpu.ops import lstm as jl

    def both():
        return tl.default_compute_dtype(), jl.default_compute_dtype()

    try:
        assert both() == (None, None)
        monkeypatch.setenv("VOICE100_TPU_MATMUL_DTYPE", "bfloat16")
        assert both() == (torch.bfloat16, jnp.bfloat16)
        monkeypatch.setenv("VOICE100_TPU_MATMUL_DTYPE", "float32")
        assert both() == (None, None)
        tl.set_default_compute_dtype(torch.bfloat16)
        jl.set_default_compute_dtype(jnp.bfloat16)
        assert both() == (torch.bfloat16, jnp.bfloat16)
        with pytest.raises(ValueError, match="bfloat16"):
            tl.set_default_compute_dtype(torch.float16)
    finally:
        jl.set_default_compute_dtype(None)


def test_the_wrappers_refuse_a_dtype_no_variant_takes():
    """Kernels take float32 or bf16 ``xg`` and the matching states; any
    other dtype raises before anything is launched, on every device."""
    from voice100_tpu_torch.ops.lstm_cuda import _variant

    assert _variant("k", torch.zeros(1)) == "f32"
    assert _variant("k", torch.zeros(1, dtype=torch.bfloat16)) == "bf16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _variant("k", torch.zeros(1, dtype=torch.float16))
    _, x, lengths, _, (w_ih, w_hh, bias) = _layer("ragged")
    with pytest.raises(ValueError, match="only bfloat16 or None"):
        bilstm_cuda(w_ih, w_hh, bias, torch.from_numpy(x), torch.from_numpy(lengths),
                    compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="only bfloat16 or None"):
        bilstm_train_cuda(w_ih, w_hh, bias, torch.from_numpy(x), torch.from_numpy(lengths),
                          compute_dtype=torch.float16)


def _flax_conv_block(x, weight, bias, stride, padding, transpose=False):
    """flax's block on the same weights under the bf16 knob."""
    from voice100_tpu.models.layers import ConvLayerBlock as JaxBlock
    from voice100_tpu.models.layers import ConvTransposeLayerBlock as JaxTBlock
    from voice100_tpu.ops.lstm import set_default_compute_dtype

    cls = JaxTBlock if transpose else JaxBlock
    block = cls(out_channels=weight.shape[1] if transpose else weight.shape[0],
                kernel_size=weight.shape[2], stride=stride, padding=padding,
                use_bias=bias is not None)
    # torch's conv weight [out, in, k] is flax's kernel [k, in, out]; a
    # transposed one [in, out, k] is the same taps flipped in time
    kernel = (np.flip(weight, 2).transpose(2, 0, 1) if transpose
              else weight.transpose(2, 1, 0))
    key = "ConvTranspose" if transpose else "Conv"
    params = {"LayerNorm_0": {"scale": np.ones(kernel.shape[2], np.float32),
                              "bias": np.zeros(kernel.shape[2], np.float32)}}
    if transpose:
        params["kernel"] = kernel
        if bias is not None:
            params["bias"] = bias
    else:
        params[f"{key}_0"] = {"kernel": kernel, **({"bias": bias} if bias is not None else {})}
    set_default_compute_dtype(jnp.bfloat16)
    try:
        return np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    finally:
        set_default_compute_dtype(None)


@pytest.mark.parametrize("stride,padding,bias", [(2, 2, False), (1, 2, False), (1, 1, True)])
def test_conv_block_in_bf16_matches_flax_under_the_knob(stride, padding, bias):
    rng = np.random.default_rng(stride + 3 * padding)
    x = rng.normal(size=(2, 19, 16)).astype(np.float32)
    block = ConvLayerBlock(16, 24, 5 if padding == 2 else 3, stride, padding, bias, device="cpu")
    block.reset_parameters(torch.Generator().manual_seed(1))
    weight = block.conv.weight.detach().numpy()
    b = block.conv.bias.detach().numpy() if bias else None
    want = _flax_conv_block(x, weight, b, stride, padding)
    with torch.no_grad():
        f32 = block(torch.from_numpy(x))
        tl.set_default_compute_dtype(torch.bfloat16)
        got = block(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_ATOL)
    assert not torch.equal(got, f32)  # the mode changed what ran
    # the conv output itself is bf16-rounded, before the LayerNorm
    conv = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2).bfloat16(),
                                      block.conv.weight.bfloat16(), None, stride, padding)
    if bias:
        conv = conv + block.conv.bias.bfloat16()[:, None]
    with torch.no_grad():
        again = torch.nn.functional.gelu(block.layer_norm(conv.float().transpose(1, 2)))
    assert torch.equal(got, again)


def test_conv_transpose_block_stays_float32_under_the_knob():
    """``ConvTransposeLayerBlock`` runs in float32 under the bf16 mode, as
    JAX's does (``voice100_tpu/models/layers.py:103-105``)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    block = ConvTransposeLayerBlock(16, 8, 5, 2, 2, True, device="cpu")
    block.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        f32 = block(torch.from_numpy(x))
        tl.set_default_compute_dtype(torch.bfloat16)
        got = block(torch.from_numpy(x))
    assert torch.equal(got, f32)
    want = _flax_conv_block(x, block.conv.weight.detach().numpy(),
                            block.conv.bias.detach().numpy(), 2, 2, transpose=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
