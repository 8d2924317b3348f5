"""Port CTC Viterbi forced alignment vs the JAX package (CPU).

The plain ``ctc_viterbi_align`` (and its split into ``viterbi_forward``,
``viterbi_final`` and ``viterbi_backtrace``, the plain twins of the two
CUDA kernels) is held against the JAX scan ``ctc_viterbi_align`` and the
Pallas kernels in interpret mode (``ctc_viterbi_pallas``): paths and
labels integer-equal, scores within rtol 1e-6 (max and one float32 add
are exact, so they agree bit for bit in practice). The cases are those of
``tests/test_ctc_pallas.py:100-123`` (B=5, T=41, V=11, L=9, a
repeated-label row, ragged lengths) plus an empty target, a row that
cannot align, ``T = 1`` and a 2-move between equal labels; one case is
also held against the NumPy oracle of ``tests/test_ops_parity.py:165``,
moves included. The CUDA kernels run only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.ops import ctc as tctc
from voice100_tpu_torch.ops import viterbi_cuda


def _pallas_case():
    rng = np.random.RandomState(3)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(5, 41, 11).astype(np.float32))))
    tgt = rng.randint(1, 11, size=(5, 9)).astype(np.int32)
    tgt[0] = [2, 2, 3, 3, 1, 1, 4, 4, 5]
    return lp, tgt, np.asarray([41, 33, 25, 41, 20], np.int32), np.asarray([9, 6, 4, 9, 2], np.int32)


def _edge_case():
    """Row 1 has no target, row 2 cannot align (6 frames for 9 labels),
    row 3 holds labels past its target length."""
    lp, tgt, _, _ = _pallas_case()
    return lp, tgt, np.asarray([41, 30, 6, 41, 0], np.int32), np.asarray([9, 0, 9, 3, 2], np.int32)


def _one_frame_case():
    lp, tgt, _, tl = _pallas_case()
    return lp[:, :1].copy(), tgt, np.asarray([1, 1, 0, 1, 1], np.int32), tl


def _equal_labels_case():
    """A 2-move between equal labels: each frame strongly prefers label 3,
    so the best path of ``3 3 3`` over 3 frames skips both blanks, which
    the loss's skip gate would forbid but the Viterbi's landing gate
    allows."""
    logits = np.full((2, 3, 5), -4.0, np.float32)
    logits[:, :, 3] = 4.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    tgt = np.asarray([[3, 3, 3], [3, 1, 3]], np.int32)
    return lp, tgt, np.asarray([3, 3], np.int32), np.asarray([3, 3], np.int32)


CASES = {"pallas_shapes": _pallas_case, "edges": _edge_case, "one_frame": _one_frame_case,
         "equal_labels": _equal_labels_case}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port(lp, tgt, il, tl):
    return tctc.ctc_viterbi_align(*_t(lp, tgt, il, tl))


def _assert_same(got, score, path, labels):
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(path))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(labels))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(score), rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_scan(case):
    from voice100_tpu.ops.ctc import ctc_viterbi_align

    lp, tgt, il, tl = CASES[case]()
    ref = ctc_viterbi_align(*(jnp.asarray(a) for a in (lp, tgt, il, tl)))
    _assert_same(_port(lp, tgt, il, tl), ref.score, ref.path, ref.labels)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    from voice100_tpu.ops.ctc_pallas import ctc_viterbi_pallas

    lp, tgt, il, tl = CASES[case]()
    score, path, labels = ctc_viterbi_pallas(*(jnp.asarray(a) for a in (lp, tgt, il, tl)), True)
    _assert_same(_port(lp, tgt, il, tl), score, path, labels)


def test_empty_label_axis_matches_jax():
    """Targets of shape [B, 0] (S = 1): the lattice helpers keep the row
    width for shifts wider than the row, for the Viterbi and the loss."""
    from voice100_tpu.ops.ctc import ctc_loss, ctc_viterbi_align

    lp, _, il, _ = _pallas_case()
    tgt, tl = np.zeros((5, 0), np.int32), np.zeros(5, np.int32)
    ref = ctc_viterbi_align(*(jnp.asarray(a) for a in (lp, tgt, il, tl)))
    got = _port(lp, tgt, il, tl)
    _assert_same(got, ref.score, ref.path, ref.labels)
    assert (got.path == 0).all()
    want = ctc_loss(*(jnp.asarray(a) for a in (lp, tgt, il, tl)), reduction="none")
    loss = tctc.ctc_loss(*_t(lp, tgt, il, tl), reduction="none")
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), rtol=1e-5)


def test_edge_rows():
    """The empty target stays on state 0, the row that cannot align keeps
    the -1e30 sentinel score, frames past each length are zeroed, and the
    2-move between equal labels is taken."""
    got = _port(*_edge_case())
    assert (got.path[1, :30] == 0).all() and got.score[1] > -1e3
    assert got.score[2] <= -1e29
    assert (got.path[4] == 0).all() and (got.labels[4] == 0).all()
    got = _port(*_equal_labels_case())
    np.testing.assert_array_equal(got.path[0].numpy(), [1, 3, 5])
    np.testing.assert_array_equal(got.labels[0].numpy(), [3, 3, 3])
    np.testing.assert_array_equal(got.path[1].numpy(), [1, 3, 5])


def _oracle(log_probs, labels, max_move=3):
    """The NumPy port of the reference dynamic program of
    tests/test_ops_parity.py:170-202, returning its backpointers too."""
    time = log_probs.shape[0]
    z = np.zeros(labels.shape[0] * 2 + 1, dtype=np.int64)
    z[1::2] = labels
    s_len = z.shape[0]
    alpha = np.full(s_len, -np.inf)
    alpha[0] = log_probs[0, z[0]]
    if s_len > 1:
        alpha[1] = log_probs[0, z[1]]
    bp = np.zeros((time, s_len), dtype=np.int64)
    for t in range(1, time):
        new = np.full(s_len, -np.inf)
        for s in range(s_len):
            best, best_m = -np.inf, 0
            for m in range(max_move):
                if s - m < 0 or (m > 0 and m % 2 == 0 and z[s] == 0):
                    continue
                if alpha[s - m] > best:
                    best, best_m = alpha[s - m], m
            new[s] = best + log_probs[t, z[s]]
            bp[t, s] = best_m
        alpha = new
    j = s_len - 1 if alpha[s_len - 1] > alpha[s_len - 2] else s_len - 2
    score = alpha[j]
    path = np.zeros(time, dtype=np.int64)
    for t in range(time - 1, -1, -1):
        path[t] = j
        j -= bp[t, j]
    return score, path, z[path], bp


def test_twins_match_numpy_oracle():
    """The forward's moves, the final state, the score, the path and the
    labels of each row against the reference recurrence run on that row
    alone (tests/test_ops_parity.py:204-238's inputs)."""
    rng = np.random.RandomState(0)
    batch, time, vocab = 3, 15, 6
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(batch, time, vocab).astype(np.float32)),
                                       axis=-1))
    label_lens = np.array([5, 3, 4], dtype=np.int32)
    labels = np.zeros((batch, 5), dtype=np.int32)
    for b in range(batch):
        labels[b, :label_lens[b]] = rng.randint(1, vocab, label_lens[b])
    input_lens = np.array([15, 10, 12], dtype=np.int32)
    lpt, tgt, il, tl = _t(lp, labels, input_lens, label_lens)
    z, _, valid = tctc.ctc_prep(tgt, tl)
    moves, last = tctc.viterbi_forward(lpt, z, valid, il)
    final_pos, score = tctc.viterbi_final(last, tl)
    path, lab = tctc.viterbi_backtrace(moves, final_pos, il, z)
    assert moves.dtype == torch.uint8 and (moves[0] == 0).all()
    for b in range(batch):
        n, s_len = input_lens[b], 2 * label_lens[b] + 1
        want_score, want_path, want_labels, bp = _oracle(lp[b, :n], labels[b, :label_lens[b]])
        np.testing.assert_allclose(float(score[b]), want_score, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(path[b, :n].numpy(), want_path)
        np.testing.assert_array_equal(lab[b, :n].numpy(), want_labels)
        np.testing.assert_array_equal(moves[1:n, b, :s_len].numpy(), bp[1:])
        assert (moves[n:, b] == 0).all() and (path[b, n:] == 0).all()


def test_wrappers_run_the_twins_on_cpu_without_launching():
    lp, tgt, il, tl = _pallas_case()
    before = (viterbi_cuda.viterbi_forward_cuda.launches,
              viterbi_cuda.viterbi_backtrace_cuda.launches)
    got = viterbi_cuda.ctc_viterbi_align_cuda(*_t(lp, tgt, il, tl))
    want = _port(lp, tgt, il, tl)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (viterbi_cuda.viterbi_forward_cuda.launches,
            viterbi_cuda.viterbi_backtrace_cuda.launches) == before


def test_wrappers_reject_other_devices_and_rules():
    lp = torch.empty(2, 5, 7, device="meta")
    z = torch.zeros(2, 3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_forward_cuda(lp, z, z.bool(), torch.tensor([5, 4]))
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_backtrace_cuda(torch.empty(5, 2, 3, dtype=torch.uint8, device="meta"),
                                            torch.tensor([2, 2]), torch.tensor([5, 4]), z)
    args = _t(*_pallas_case())
    with pytest.raises(ValueError, match="blank 0"):
        tctc.ctc_viterbi_align(*args, blank=1)
    with pytest.raises(ValueError, match="max_move=3"):
        viterbi_cuda.ctc_viterbi_align_cuda(*args, max_move=4)
