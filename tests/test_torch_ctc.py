"""Port CTC loss vs the JAX package (CPU).

The plain versions of the two CUDA lattice kernels (``ctc_alpha``,
``ctc_alpha_adjoint``) are held against the Pallas kernels in interpret
mode (``_ctc_fwd_call`` / ``_ctc_bwd_call``) on the unpadded states, and
the autograd Function's ``ll`` and gradients against ``ctc_ll_pallas``,
at the tolerances the JAX package holds its kernels to
(``tests/test_ctc_pallas.py:36-87``): both float32, differing only in the
order of sums. The loss is also held to ``nn.CTCLoss(zero_infinity=True)``
within 1e-4, as ``tests/test_ops_parity.py:117-145`` holds the JAX one.
The CUDA kernels run only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.ops import ctc as tctc
from voice100_tpu_torch.ops import ctc_cuda


def _random_case(seed, batch=4, time=37, vocab=11, label_len=9):
    rng = np.random.RandomState(seed)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(batch, time, vocab).astype(np.float32))))
    tgt = rng.randint(1, vocab, size=(batch, label_len)).astype(np.int32)
    il = rng.randint(time // 2, time + 1, size=(batch,)).astype(np.int32)
    tl = rng.randint(0, label_len + 1, size=(batch,)).astype(np.int32)
    return lp, tgt, il, tl


def _repeats_case():
    """Repeated labels (the skip gate), two infeasible rows (row 1: nine
    equal labels need 17 frames and get 10; row 3: 17 in 12) and a row
    with no target (row 4)."""
    rng = np.random.RandomState(2)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(5, 24, 7).astype(np.float32))))
    tgt = np.asarray([[3, 3, 4, 4, 1, 1, 2, 2, 5],
                      [1, 1, 1, 1, 1, 1, 1, 1, 1],
                      [2, 5, 2, 5, 2, 5, 2, 5, 2],
                      [6, 6, 6, 6, 6, 6, 6, 6, 6],
                      [0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    return lp, tgt, np.asarray([24, 10, 24, 12, 20], np.int32), np.asarray([9, 9, 9, 9, 0], np.int32)


def _edges_case():
    """Rows at the edges of the kernels' time loops: an input of one frame
    (row 0), no target (row 1), a row held for all but 3 of its 40 frames
    (row 2), one label repeated (row 3), and a full-length row (row 4)."""
    rng = np.random.RandomState(7)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(5, 40, 9).astype(np.float32))))
    tgt = rng.randint(1, 9, size=(5, 6)).astype(np.int32)
    tgt[3] = 4
    il = np.asarray([1, 17, 3, 40, 40], np.int32)
    tl = np.asarray([1, 0, 1, 6, 6], np.int32)
    tgt[np.arange(6)[None, :] >= tl[:, None]] = 0
    return lp, tgt, il, tl


def _empty_labels_case():
    """A batch whose label axis is empty: S = 1, the blank alone."""
    rng = np.random.RandomState(8)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(3, 12, 5).astype(np.float32))))
    return lp, np.zeros((3, 0), np.int32), np.asarray([12, 1, 7], np.int32), np.zeros(3, np.int32)


def _long_case():
    """The longest target the train phase of chip_smoke.py draws (150
    labels, S = 301) in 320 frames, beside a short row."""
    rng = np.random.RandomState(9)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(2, 320, 29).astype(np.float32))))
    tgt = rng.randint(1, 29, size=(2, 150)).astype(np.int32)
    tl = np.asarray([150, 40], np.int32)
    tgt[1, 40:] = 0
    return lp, tgt, np.asarray([320, 200], np.int32), tl


CASES = {"random0": lambda: _random_case(0), "random1": lambda: _random_case(1),
         "repeats": _repeats_case, "edges": _edges_case, "empty_labels": _empty_labels_case,
         "long": _long_case}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_lattice(lp, tgt, il, tl):
    """JAX's padded lattice inputs and its alpha (interpret mode)."""
    from voice100_tpu.ops.ctc_pallas import _NEG_INF, _ctc_fwd_call, _prep

    _, can_skip, valid, lp_z, s_len, s_pad = _prep(jnp.asarray(lp), jnp.asarray(tgt),
                                                   jnp.asarray(il), jnp.asarray(tl))
    lanes = jnp.arange(s_pad)
    alpha0 = jnp.where((lanes[None, :] < 2) & (valid != 0), lp_z[:, 0], _NEG_INF)
    alpha = _ctc_fwd_call(lp_z, alpha0, can_skip, valid, jnp.asarray(il), interpret=True)
    return lp_z, can_skip, valid, alpha, s_len


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_alpha_matches_pallas_interpret(case):
    lp, tgt, il, tl = CASES[case]()
    _, _, _, alpha, s_len = _jax_lattice(lp, tgt, il, tl)
    lpt, tgtt, ilt, tlt = _t(lp, tgt, il, tl)
    z, can_skip, valid = tctc.ctc_prep(tgtt, tlt)
    got = tctc.ctc_alpha(lpt, z, can_skip, valid, ilt)
    assert got.shape == (lp.shape[1], lp.shape[0], s_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(alpha)[..., :s_len], rtol=1e-5, atol=1e-5)


def _adjoints(case):
    """The plain adjoint and the Pallas one (interpret mode) on the unpadded
    states, both seeded with uniform(0.1, 1) on every state."""
    from voice100_tpu.ops.ctc_pallas import _ctc_bwd_call

    lp, tgt, il, tl = CASES[case]()
    lp_z, can_skip_j, valid_j, alpha, s_len = _jax_lattice(lp, tgt, il, tl)
    batch, s_pad = valid_j.shape
    seed = np.random.default_rng(3).uniform(0.1, 1.0, (batch, s_pad)).astype(np.float32)
    seed[:, s_len:] = 0.0
    want = _ctc_bwd_call(lp_z, alpha, jnp.asarray(seed), can_skip_j, valid_j, jnp.asarray(il),
                         interpret=True)
    _, _, ilt, tlt = _t(lp, tgt, il, tl)
    _, can_skip, valid = tctc.ctc_prep(torch.from_numpy(tgt), tlt)
    got = tctc.ctc_alpha_adjoint(torch.from_numpy(np.array(alpha)[..., :s_len]),
                                 torch.from_numpy(seed[:, :s_len]), can_skip, valid, ilt)
    return got.numpy(), np.asarray(want)[..., :s_len]


@pytest.mark.parametrize("case", sorted(set(CASES) - {"long"}))
def test_plain_adjoint_matches_pallas_interpret(case):
    got, want = _adjoints(case)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_adjoint_matches_pallas_interpret_on_the_long_lattice():
    """S = 301 over 320 steps. A seed on every state (not the loss's two end
    states) makes the adjoint grow to ~1e2, and 320 steps of sums of
    positive terms, each through another exp/log implementation, drift by
    a few float32 ulps a step: entrywise up to 6e-5 relative on small
    entries. So the lattice is held as chip_smoke.py holds kernel 5: max
    abs error over the max magnitude within 1e-5 (measured 2e-6); an
    indexing or gate fault moves whole entries."""
    got, want = _adjoints("long")
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def _port_loss(lp, tgt, il, tl):
    lpt = torch.from_numpy(np.array(lp)).requires_grad_()
    _, tgtt, ilt, tlt = _t(lp, tgt, il, tl)
    ll = ctc_cuda.ctc_ll(lpt, tgtt, ilt, tlt)
    loss = tctc.reduce_loss(ll, tlt)
    loss.backward()
    return ll.detach().numpy(), loss.item(), lpt.grad.numpy()


def _jax_loss(lp, tgt, il, tl):
    from voice100_tpu.ops.ctc_pallas import ctc_ll_pallas

    args = [jnp.asarray(a) for a in (tgt, il, tl)]
    ll = ctc_ll_pallas(jnp.asarray(lp), *args, True)

    def loss_fn(x):
        loss = -ctc_ll_pallas(x, *args, True)
        loss = jnp.where(loss >= 1e30 / 2, 0.0, loss)
        return jnp.mean(loss / jnp.maximum(args[2], 1))

    return np.asarray(ll), float(loss_fn(jnp.asarray(lp))), np.asarray(jax.grad(loss_fn)(jnp.asarray(lp)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_ll_loss_and_grad_match_pallas(case):
    lp, tgt, il, tl = CASES[case]()
    ll, loss, grad = _port_loss(lp, tgt, il, tl)
    want_ll, want_loss, want_grad = _jax_loss(lp, tgt, il, tl)
    np.testing.assert_allclose(ll, want_ll, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-6)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_torch_ctc_loss(case):
    lp, tgt, il, tl = CASES[case]()
    lpt, tgtt, ilt, tlt = _t(lp, tgt, il, tl)
    want = torch.nn.CTCLoss(zero_infinity=True)(lpt.transpose(0, 1), tgtt.long(), ilt.long(),
                                                tlt.long()).item()
    assert abs(ctc_cuda.ctc_loss_cuda(lpt, tgtt, ilt, tlt).item() - want) < 1e-4
    assert abs(tctc.ctc_loss(lpt, tgtt, ilt, tlt).item() - want) < 1e-4


def test_infeasible_rows_have_zero_loss_and_exactly_zero_gradient():
    lp, tgt, il, tl = _repeats_case()
    ll, _, grad = _port_loss(lp, tgt, il, tl)
    for row in (1, 3):                         # no path: the -1e30 sentinel
        assert ll[row] < -1e29 and np.abs(grad[row]).max() == 0.0
    for row in (0, 2, 4):
        assert ll[row] > -1e3 and np.abs(grad[row]).max() > 0.0
    lpt, tgtt, ilt, tlt = _t(lp, tgt, il, tl)
    per_sample = ctc_cuda.ctc_loss_cuda(lpt, tgtt, ilt, tlt, reduction="none")
    assert (per_sample[[1, 3]] == 0).all() and (per_sample[[0, 2, 4]] > 0).all()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reductions_match_jax_scan(reduction):
    from voice100_tpu.ops.ctc import ctc_loss

    lp, tgt, il, tl = _random_case(4)
    want = np.asarray(ctc_loss(*(jnp.asarray(a) for a in (lp, tgt, il, tl)), reduction=reduction))
    got = ctc_cuda.ctc_loss_cuda(*_t(lp, tgt, il, tl), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_autograd_loss_matches_the_function():
    """The plain ``ctc_loss`` (autograd through the forward lattice) and the
    Function (hand adjoint) give the same gradient."""
    lp, tgt, il, tl = _random_case(5)
    a = torch.from_numpy(np.array(lp)).requires_grad_()
    tctc.ctc_loss(a, *_t(tgt, il, tl)).backward()
    _, _, grad = _port_loss(lp, tgt, il, tl)
    np.testing.assert_allclose(grad, a.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_wrappers_reject_other_devices_and_blank():
    lp = torch.empty(2, 5, 7, device="meta")
    z = torch.zeros(2, 3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ctc_cuda.ctc_alpha_cuda(lp, z, z.bool(), z.bool(), torch.tensor([5, 4]))
    with pytest.raises(ValueError):
        ctc_cuda.ctc_alpha_adjoint_cuda(torch.empty(5, 2, 3, device="meta"),
                                        torch.empty(2, 3, device="meta"), z.bool(), z.bool(),
                                        torch.tensor([5, 4]))
    with pytest.raises(ValueError):
        ctc_cuda.ctc_loss_cuda(torch.zeros(1, 3, 4), torch.ones(1, 1, dtype=torch.int32),
                               torch.tensor([3]), torch.tensor([1]), blank=1)


def test_wrappers_reject_lattices_past_the_kernels_limit_launching_nothing():
    """An ``S`` past ``MAX_STATES`` (or the shared memory it would need)
    raises before any library is loaded or kernel launched: no GPU needed."""
    s_len = ctc_cuda.MAX_STATES + 2
    assert ctc_cuda.adjoint_smem_bytes(ctc_cuda.MAX_STATES) <= ctc_cuda._SMEM_LIMIT
    assert ctc_cuda.alpha_smem_bytes(ctc_cuda.MAX_STATES, 29) <= ctc_cuda._SMEM_LIMIT
    z = torch.zeros(2, s_len, dtype=torch.int64, device="meta")
    before = (ctc_cuda.ctc_alpha_cuda.launches, ctc_cuda.ctc_alpha_adjoint_cuda.launches)
    with pytest.raises(ValueError, match="lattice states"):
        ctc_cuda.ctc_alpha_cuda(torch.empty(2, 5, 7, device="meta"), z, z.bool(), z.bool(),
                                torch.tensor([5, 4]))
    with pytest.raises(ValueError, match="lattice states"):
        ctc_cuda.ctc_alpha_adjoint_cuda(torch.empty(5, 2, s_len, device="meta"),
                                        torch.empty(2, s_len, device="meta"), z.bool(), z.bool(),
                                        torch.tensor([5, 4]))
    assert (ctc_cuda.ctc_alpha_cuda.launches, ctc_cuda.ctc_alpha_adjoint_cuda.launches) == before
