"""Port biLSTM training pair vs the JAX package (CPU).

The plain versions of the two CUDA training kernels
(``bilstm_train_fwd``: outputs and pre-update states; ``bilstm_train_bwd``:
dG) are held against the Pallas training kernels in interpret mode
(``_lstm_train_fwd_pair`` / ``_lstm_train_bwd_pair``), and the
autograd Function's gradients against ``jax.grad`` of ``_bilstm_op`` and
of the scan ``bilstm``, at the tolerances the JAX package holds its own
kernels to (``tests/test_ops_parity.py:368-410``): both sides float32,
differing only in summation order. ``BiLSTM`` in training mode is checked
for gradients and for dropout between layers only. The CUDA kernels run
only on the card (``chip_smoke.py``); here the wrappers take the plain
path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.models.layers import BiLSTM
from voice100_tpu_torch.ops import lstm as tlstm
from voice100_tpu_torch.ops import lstm_cuda

D_IN, HIDDEN, TIME = 8, 16, 12
LENGTHS = [[TIME, 7, 3], [1, TIME, 5, 9]]
# The persistent forward kernel's edge shapes, as (lengths, hidden, time):
# a batch above one 64-row pass of its product at a width it takes (H a
# multiple of 32), T=1, all rows of one length short of T, a zero-length row.
_B70 = np.random.default_rng(70).integers(0, TIME + 1, size=70)
_B70[:2] = TIME, 0
CASES = [pytest.param(lengths, HIDDEN, TIME, id=f"lengths{i}")
         for i, lengths in enumerate(LENGTHS)] + [
    pytest.param(_B70.tolist(), 32, TIME, id="b70_h32"),
    pytest.param([1, 0, 1], HIDDEN, 1, id="t1"),
    pytest.param([9, 9, 9, 9], HIDDEN, TIME, id="equal_lengths"),
    pytest.param([TIME, 0, 5], HIDDEN, TIME, id="zero_length_row"),
]


def _params(seed, d_in=D_IN, layers=1, hidden=HIDDEN):
    from voice100_tpu.ops.lstm import init_lstm_params

    return init_lstm_params(jax.random.PRNGKey(seed), d_in, hidden, layers)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _case(seed, lengths, hidden=HIDDEN, time=TIME):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), time, D_IN)).astype(np.float32)
    dout = rng.standard_normal((len(lengths), time, 2 * hidden)).astype(np.float32)
    return x, np.asarray(lengths, np.int32), dout


def _jax_pair_inputs(layer, x, lens):
    """The JAX kernels' layout: per direction ``[T, B, 4H]``, the backward
    one reversed in time, and ``W_hh^T`` stacked ``[2, H, 4H]``."""
    from voice100_tpu.ops.lstm_pallas import _dir_xg, _stack_whh

    xj = jnp.asarray(x)
    return (_dir_xg(layer["fwd"], xj, False), _dir_xg(layer["bwd"], xj, True),
            _stack_whh(layer), jnp.asarray(lens))


def _to_source(fwd, bwd):
    """JAX per-direction ``[T, B, *]`` (bwd in loop order) -> the port's
    ``[2, B, T, *]`` in source time."""
    return np.stack([np.swapaxes(np.asarray(fwd), 0, 1),
                     np.swapaxes(np.asarray(bwd)[::-1], 0, 1)])


@pytest.mark.parametrize("lengths,hidden,time", CASES)
def test_plain_train_fwd_matches_pallas_interpret(lengths, hidden, time):
    from voice100_tpu.ops.lstm_pallas import _lstm_train_fwd_pair

    layer = _params(0, hidden=hidden)[0]
    x, lens, _ = _case(1, lengths, hidden, time)
    xg_f, xg_b, whh2, lj = _jax_pair_inputs(layer, x, lens)
    (out_f, hs_f, cs_f), (out_b, hs_b, cs_b) = _lstm_train_fwd_pair(
        xg_f, xg_b, whh2, lj, block_t=1, interpret=True)
    w_ih, w_hh, bias = tlstm.stack_directions(_torch(layer))
    xg = tlstm.project_inputs(w_ih, bias, torch.from_numpy(x))
    out, h_prev, c_prev = tlstm.bilstm_train_fwd(xg, w_hh, torch.from_numpy(lens))
    want_out = np.concatenate(list(_to_source(out_f, out_b)), -1)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_prev.numpy(), _to_source(hs_f, hs_b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c_prev.numpy(), _to_source(cs_f, cs_b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lengths,hidden,time", CASES)
def test_plain_train_bwd_matches_pallas_interpret(lengths, hidden, time):
    from voice100_tpu.ops.lstm_pallas import _lstm_train_bwd_pair, _lstm_train_fwd_pair

    layer = _params(2, hidden=hidden)[0]
    x, lens, dout = _case(3, lengths, hidden, time)
    xg_f, xg_b, whh2, lj = _jax_pair_inputs(layer, x, lens)
    (_, hs_f, cs_f), (_, hs_b, cs_b) = _lstm_train_fwd_pair(
        xg_f, xg_b, whh2, lj, block_t=1, interpret=True)
    dj = jnp.asarray(dout)
    dg_f, dg_b = _lstm_train_bwd_pair(
        xg_f, xg_b, whh2, lj, {"fwd": (hs_f, cs_f), "bwd": (hs_b, cs_b)},
        jnp.swapaxes(dj[..., :hidden], 0, 1), jnp.swapaxes(dj[..., hidden:], 0, 1)[::-1],
        block_t=1, interpret=True)

    w_ih, w_hh, bias = tlstm.stack_directions(_torch(layer))
    xg = tlstm.project_inputs(w_ih, bias, torch.from_numpy(x))
    lt = torch.from_numpy(lens)
    _, h_prev, c_prev = tlstm.bilstm_train_fwd(xg, w_hh, lt)
    dg = tlstm.bilstm_train_bwd(xg, w_hh, lt, h_prev, c_prev, torch.from_numpy(dout))
    np.testing.assert_allclose(dg.numpy(), _to_source(dg_f, dg_b), rtol=1e-4, atol=1e-5)


def _module(layer_params, d_in=D_IN):
    module = BiLSTM(d_in, HIDDEN, len(layer_params), device="cpu")
    module.load_state_dict({
        f"{theirs}_l{k}{suffix}": torch.from_numpy(np.array(layer[direction][ours]))
        for k, layer in enumerate(layer_params)
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
        for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
    })
    return module


@pytest.mark.parametrize("reference", ["pallas", "scan"])
@pytest.mark.parametrize("lengths", LENGTHS)
def test_function_gradients_match_jax_grad(reference, lengths):
    """Gradients of ``sum(out * cotangent)`` with respect to every weight
    and to ``x``: the port's Function (plain twins on the CPU) against
    ``jax.grad`` of the Pallas custom VJP and of the scan."""
    from voice100_tpu.ops.lstm import bilstm
    from voice100_tpu.ops.lstm_pallas import _bilstm_op

    layer = _params(4)[0]
    x, lens, cot = _case(5, lengths)
    lj, cj = jnp.asarray(lens), jnp.asarray(cot)
    if reference == "pallas":
        fn = lambda p, xx: jnp.sum(_bilstm_op(False, p, xx, lj) * cj)  # noqa: E731
    else:
        fn = lambda p, xx: jnp.sum(bilstm(p, xx, lj) * cj)  # noqa: E731
    want_p, want_x = jax.grad(fn, argnums=(0, 1))(layer, jnp.asarray(x))

    module = _module([layer]).eval()
    xt = torch.from_numpy(x).requires_grad_()
    before = lstm_cuda.bilstm_cuda.launches
    (module(xt, torch.from_numpy(lens)) * torch.from_numpy(cot)).sum().backward()
    assert lstm_cuda.bilstm_cuda.launches == before
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-5)
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            got = getattr(module, f"{theirs}_l0{suffix}").grad.numpy()
            np.testing.assert_allclose(got, np.asarray(want_p[direction][ours]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{direction}.{ours}")


def test_function_matches_autograd_through_the_plain_loop():
    """The Function's hand-written backward equals autograd through the
    plain forward loop (float64, so only the algebra is compared)."""
    torch.manual_seed(0)
    w_ih = torch.randn(2, 4 * HIDDEN, D_IN, dtype=torch.float64) * 0.3
    w_hh = torch.randn(2, 4 * HIDDEN, HIDDEN, dtype=torch.float64) * 0.3
    bias = torch.randn(2, 4 * HIDDEN, dtype=torch.float64) * 0.1
    x = torch.randn(3, TIME, D_IN, dtype=torch.float64)
    lens = torch.tensor([TIME, 6, 1])
    cot = torch.randn(3, TIME, 2 * HIDDEN, dtype=torch.float64)
    grads = []
    for fn in (tlstm.bilstm, lstm_cuda.bilstm_train_cuda):
        leaves = [t.clone().requires_grad_() for t in (w_ih, w_hh, bias, x)]
        (fn(*leaves, lens) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for want, got in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_gradients_reach_every_parameter_in_training_mode():
    module = _module(_params(6, layers=2)).train()
    x, lens, cot = _case(7, [TIME, 8, 2])
    out = module(torch.from_numpy(x), torch.from_numpy(lens),
                 torch.Generator().manual_seed(0))
    (out * torch.from_numpy(cot)).sum().backward()
    for name, param in module.named_parameters():
        assert param.grad is not None, name
        assert torch.isfinite(param.grad).all() and param.grad.abs().max() > 0, name


def test_dropout_only_in_training_mode_and_between_layers():
    layers = _params(8, layers=2)
    x, lens, _ = _case(9, [TIME, 10, 4])
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    module = _module(layers)
    with torch.no_grad():
        eval_out = module.eval()(xt, lt, torch.Generator().manual_seed(1))
        eval_again = module(xt, lt, torch.Generator().manual_seed(2))
        train_out = module.train()(xt, lt, torch.Generator().manual_seed(1))
        # by hand: layer 0, dropout with the same generator, layer 1, no dropout after
        (w0, h0, b0), (w1, h1, b1) = module.stacked_layers()
        y0 = tlstm.bilstm(w0, h0, b0, xt, lt)
        keep = torch.empty_like(y0).bernoulli_(0.8, generator=torch.Generator().manual_seed(1))
        want = tlstm.bilstm(w1, h1, b1, torch.where(keep.bool(), y0 / 0.8, 0.0), lt)
        one_layer = _module(layers[:1])
        single_train = one_layer.train()(xt, lt, torch.Generator().manual_seed(1))
        single_eval = one_layer.eval()(xt, lt)
    torch.testing.assert_close(eval_out, eval_again, rtol=0, atol=0)
    assert (train_out - eval_out).abs().max() > 1e-3
    torch.testing.assert_close(train_out, want, rtol=1e-6, atol=1e-6)
    assert 0.15 < 1.0 - keep.mean().item() < 0.25
    torch.testing.assert_close(single_train, single_eval, rtol=0, atol=0)


def test_train_wrappers_reject_other_devices():
    xg = torch.empty(2, 3, TIME, 4 * 32, device="meta")
    w_hh = torch.empty(2, 4 * 32, 32, device="meta")
    with pytest.raises(ValueError):
        lstm_cuda.bilstm_train_fwd_cuda(xg, w_hh, torch.tensor([TIME, 3, 1]))
    h = torch.empty(2, 3, TIME, 32, device="meta")
    with pytest.raises(ValueError):
        lstm_cuda.bilstm_train_bwd_cuda(xg, w_hh, torch.tensor([TIME, 3, 1]), h, h,
                                        torch.empty(3, TIME, 64, device="meta"))
