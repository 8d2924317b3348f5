"""Port masked biLSTM vs the JAX package (CPU).

The port's plain recurrence is held against the JAX scan
(``voice100_tpu.ops.lstm``) and against the Pallas inference kernel in
interpret mode with float32 gate streaming, at rtol/atol 1e-5 as the JAX
package holds its own kernel (tests/test_ops_parity.py:254-268): both
sides are float32 and differ only in summation order. The CUDA kernel
runs only on the card (chip_smoke.py); here its wrapper takes the plain
path.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.ops import lstm as tlstm
from voice100_tpu_torch.models.layers import BiLSTM
from voice100_tpu_torch.ops import lstm_cuda

D_IN, HIDDEN, TIME = 8, 16, 12


def _params(seed, d_in=D_IN, layers=1, hidden=HIDDEN):
    from voice100_tpu.ops.lstm import init_lstm_params

    return init_lstm_params(jax.random.PRNGKey(seed), d_in, hidden, layers)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _stacked(layer):
    return tlstm.stack_directions(_torch(layer))


def _inputs(seed, lengths, time=TIME):
    x = np.random.default_rng(seed).standard_normal((len(lengths), time, D_IN))
    return x.astype(np.float32), np.asarray(lengths, np.int32)


LENGTHS = [[TIME, 7, 3], [1, TIME, 5], [TIME, TIME], [1]]
# The persistent kernels' edge shapes, as (lengths, hidden, time): a batch
# above one 64-row pass of their product at a width they take (H a multiple
# of 32), T=1, all rows of one length short of T, a zero-length row.
_B70 = np.random.default_rng(70).integers(0, TIME + 1, size=70)
_B70[:2] = TIME, 0
EDGE_CASES = [
    pytest.param(_B70.tolist(), 32, TIME, id="b70_h32"),
    pytest.param([1, 0, 1], HIDDEN, 1, id="t1"),
    pytest.param([9, 9, 9, 9], HIDDEN, TIME, id="equal_lengths"),
    pytest.param([TIME, 0, 5], HIDDEN, TIME, id="zero_length_row"),
]
CASES = [pytest.param(lengths, HIDDEN, TIME, id=f"lengths{i}")
         for i, lengths in enumerate(LENGTHS)] + EDGE_CASES


@pytest.mark.parametrize("lengths,hidden,time", CASES)
def test_plain_bilstm_matches_scan(lengths, hidden, time):
    from voice100_tpu.ops.lstm import bilstm

    params = _params(0, hidden=hidden)[0]
    x, lens = _inputs(1, lengths, time)
    ref = np.asarray(bilstm(params, jnp.asarray(x), jnp.asarray(lens)))
    got = tlstm.bilstm(*_stacked(params), torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lengths,hidden,time", CASES[:2] + EDGE_CASES)
def test_plain_bilstm_matches_pallas_interpret(monkeypatch, lengths, hidden, time):
    from voice100_tpu.ops.lstm_pallas import bilstm_pallas

    monkeypatch.setenv("VOICE100_TPU_LSTM_XG_DTYPE", "float32")
    params = _params(2, hidden=hidden)[0]
    x, lens = _inputs(3, lengths, time)
    ref = np.asarray(bilstm_pallas(params, jnp.asarray(x), jnp.asarray(lens), interpret=True))
    got = tlstm.bilstm(*_stacked(params), torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_lstm_direction_matches_jax(reverse):
    from voice100_tpu.ops.lstm import lstm_direction

    params = _params(4)[0]["fwd"]
    x, lens = _inputs(5, [TIME, 6, 1])
    ref = np.asarray(lstm_direction(params, jnp.asarray(x), jnp.asarray(lens), reverse))
    got = tlstm.lstm_direction(_torch(params), torch.from_numpy(x),
                               torch.from_numpy(lens), reverse).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_state_frozen_and_outputs_zero_past_length():
    """Packed-sequence semantics: each row equals the same sequence run
    alone at its own length, and its outputs past the length are 0."""
    params = _stacked(_params(6)[0])
    x, lens = _inputs(7, [TIME, 5, 1])
    out = tlstm.bilstm(*params, torch.from_numpy(x), torch.from_numpy(lens))
    for b, n in enumerate(lens):
        assert (out[b, n:] == 0).all()
        alone = tlstm.bilstm(*params, torch.from_numpy(x[b:b + 1, :n]),
                             torch.tensor([n], dtype=torch.int32))
        torch.testing.assert_close(out[b, :n], alone[0], rtol=1e-6, atol=1e-6)


def test_multilayer_matches_jax_and_wrapper_stays_plain_on_cpu():
    from voice100_tpu.ops.lstm import multilayer_bilstm

    params = _params(8, layers=2)
    x, lens = _inputs(9, [TIME, 8, 1])
    ref = np.asarray(multilayer_bilstm(params, jnp.asarray(x), jnp.asarray(lens)))
    module = BiLSTM(D_IN, HIDDEN, 2, device="cpu").eval()
    module.load_state_dict({
        f"{theirs}_l{k}{suffix}": torch.from_numpy(np.array(layer[direction][ours]))
        for k, layer in enumerate(params)
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
        for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
    })
    before = lstm_cuda.bilstm_cuda.launches
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    assert lstm_cuda.bilstm_cuda.launches == before
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_module_restacks_weights_after_a_load():
    """The stacked weights the module caches follow its parameters."""
    module = BiLSTM(D_IN, HIDDEN, 1, device="cpu").eval()
    first = module.stacked_layers()
    assert module.stacked_layers() is first
    state = {name: torch.randn_like(value) for name, value in module.state_dict().items()}
    module.load_state_dict(state)
    w_ih, w_hh, bias = module.stacked_layers()[0]
    torch.testing.assert_close(w_hh[1], state["weight_hh_l0_reverse"], rtol=0, atol=0)
    torch.testing.assert_close(w_ih[0], state["weight_ih_l0"], rtol=0, atol=0)
    torch.testing.assert_close(bias[0], state["bias_ih_l0"] + state["bias_hh_l0"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("lengths", [[5, 0, 12, 7, 7, 1], [3], [0, 0], _B70.tolist(),
                                     list(range(20))[::-1]])
def test_length_order_makes_the_valid_rows_a_prefix(lengths):
    """The persistent kernels walk the rows in ``length_order``: at every
    loop step the valid rows of both directions (forward ``length > s``,
    backward ``length > T-1-s``) must be a prefix of it."""
    lens = torch.tensor(lengths, dtype=torch.int32)
    order = lstm_cuda.length_order(lens)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(len(lengths)))
    sorted_lens = lens[order.long()].tolist()
    assert sorted_lens == sorted(lengths, reverse=True)
    time = max(lengths) + 2
    for s in range(time):
        for ts in (s, time - 1 - s):
            valid = [n > ts for n in sorted_lens]
            assert valid == sorted(valid, reverse=True), (s, ts)


def test_wrapper_rejects_other_devices():
    params = [t.to("meta") for t in _stacked(_params(10)[0])]
    x = torch.empty(2, TIME, D_IN, device="meta")
    with pytest.raises(ValueError):
        lstm_cuda.bilstm_cuda(*params, x, torch.tensor([TIME, 3]))
