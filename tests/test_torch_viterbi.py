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

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

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
    """On CPU tensors the one-launch wrapper returns the plain versions'
    score, path, labels and last row, and the moves in its scratch layout,
    and counts no launch; ctc_viterbi_align_cuda returns the plain
    alignment."""
    lp, tgt, il, tl = _t(*_pallas_case())
    before = viterbi_cuda.viterbi_align_lattice_cuda.launches
    got = viterbi_cuda.ctc_viterbi_align_cuda(lp, tgt, il, tl)
    for a, b in zip(got, _port(*_pallas_case())):
        assert torch.equal(a, b)
    z, _, valid = tctc.ctc_prep(tgt, tl)
    score, path, labels, packed, last = viterbi_cuda.viterbi_align_lattice_cuda(lp, z, valid, il,
                                                                                 tl)
    moves, last_ref = tctc.viterbi_forward(lp, z, valid, il)
    assert torch.equal(score, got.score) and torch.equal(path, got.path)
    assert torch.equal(labels, got.labels) and torch.equal(last, last_ref)
    assert torch.equal(viterbi_cuda.unpack_moves(packed, il, z.shape[1], lp.shape[1]), moves)
    assert viterbi_cuda.viterbi_align_lattice_cuda.launches == before


def test_wrappers_reject_other_devices_and_rules():
    lp = torch.empty(2, 5, 7, device="meta")
    z = torch.zeros(2, 3, dtype=torch.int64, device="meta")
    lengths = torch.tensor([5, 4])
    with pytest.raises(ValueError, match="device"):
        viterbi_cuda.viterbi_align_lattice_cuda(lp, z, z.bool(), lengths, lengths)
    past = torch.zeros(2, viterbi_cuda.MAX_STATES + 1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="lattice states"):
        viterbi_cuda.viterbi_align_lattice_cuda(lp, past, past.bool(), lengths, lengths)
    # a vocabulary whose two chunks of rows do not fit shared memory passes
    # the size checks (the kernel reads its emissions from device memory)
    # and reaches the device check
    wide = torch.empty(2, 5, 1000, device="meta")
    with pytest.raises(ValueError, match="device"):
        viterbi_cuda.viterbi_align_lattice_cuda(wide, z, z.bool(), lengths, lengths)
    args = _t(*_pallas_case())
    with pytest.raises(ValueError, match="blank 0"):
        tctc.ctc_viterbi_align(*args, blank=1)
    with pytest.raises(ValueError, match="max_move=3"):
        viterbi_cuda.ctc_viterbi_align_cuda(*args, max_move=4)


PACK_STATES = (1, 2, 31, 32, 33, 321, 1121, viterbi_cuda.MAX_STATES)


def _ragged(rng, batch, time):
    lengths = rng.integers(0, time + 3, size=batch)
    lengths[0], lengths[1] = time, 1
    return torch.from_numpy(lengths)


@pytest.mark.parametrize("s_len", PACK_STATES)
def test_pack_unpack_round_trips_the_plain_forward_moves(s_len):
    """The plain forward's moves (0 at t = 0 and from each ragged input
    length on) come back bit for bit from their packed layout, at every
    number of states a lane and warps a sample."""
    rng = np.random.default_rng(s_len)
    batch, time, vocab = 4, 37, 7
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((batch, time, vocab))).float(), -1)
    z = torch.from_numpy(rng.integers(0, vocab, size=(batch, s_len)))
    z[:, 0::2] = 0
    valid = torch.arange(s_len)[None, :] < torch.from_numpy(rng.integers(1, s_len + 1, size=batch))[:, None]
    il = _ragged(rng, batch, time)
    moves, _ = tctc.viterbi_forward(lp, z, valid, il)
    packed = viterbi_cuda.pack_moves(moves)
    lay = viterbi_cuda.viterbi_layout(s_len)
    assert packed.dtype == torch.int32
    assert tuple(packed.shape) == (batch, -(-(time - 1) // viterbi_cuda.CHUNK), lay.words,
                                   viterbi_cuda.CHUNK)
    assert torch.equal(viterbi_cuda.unpack_moves(packed, il, s_len, time), moves)


@pytest.mark.parametrize("s_len", PACK_STATES)
def test_pack_unpack_round_trips_every_move_value(s_len):
    """Moves 0, 1 and 2 in every bit position of a word, the top one
    included (its sign bit in int32), round-trip; rows the kernel does not
    write (t = 0, t >= length) unpack as 0 whatever the scratch holds."""
    rng = np.random.default_rng(s_len + 1)
    batch, time = 3, 70
    il = _ragged(rng, batch, time)
    moves = torch.from_numpy(rng.integers(0, 3, size=(time, batch, s_len))).to(torch.uint8)
    t = torch.arange(time)[:, None]
    moves *= ((t >= 1) & (t < il[None, :]))[:, :, None]
    packed = viterbi_cuda.pack_moves(moves)
    assert torch.equal(viterbi_cuda.unpack_moves(packed, il, s_len, time), moves)
    garbage = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=packed.shape)).int()
    keep = (torch.arange(packed.shape[1] * viterbi_cuda.CHUNK) + 1).view(1, -1, 1) < il.view(-1, 1, 1)
    keep = keep.view(batch, packed.shape[1], viterbi_cuda.CHUNK, 1).transpose(2, 3)
    assert torch.equal(viterbi_cuda.unpack_moves(torch.where(keep, packed, garbage), il, s_len,
                                                 time), moves)


def _old_max_states(vocab):
    """The largest S the two-kernel Viterbi took: its forward's shared
    memory, 4 S + chunk V floats with chunk = min(32, max(1, 4096 // V)),
    within 48 KB (0 where no S fits)."""
    chunk = min(32, max(1, 4096 // vocab))
    return max(0, (48 * 1024 // 4 - chunk * vocab) // 4)


def test_layout_covers_every_lattice_up_to_the_limit():
    """Every S up to MAX_STATES is covered by its lanes (k states each, at
    least K_MIN, at most K_MAX, the fewest that cover it) and warps (WARPS,
    more only past 32 * WARPS * K_MAX states); one past the limit raises.
    No S the two-kernel Viterbi took, at any vocabulary it took (up to
    12,287 classes), gets a launch whose shared memory misses the card's
    limit: the ring of rows where it fits, else none."""
    vc = viterbi_cuda
    for s_len in range(1, vc.MAX_STATES + 1):
        lay = vc.viterbi_layout(s_len)
        assert vc.K_MIN <= lay.k <= vc.K_MAX and vc.WARPS <= lay.warps <= vc.MAX_WARPS
        assert 32 * lay.k * lay.warps >= s_len and lay.words == 32 * lay.warps
        assert lay.k == vc.K_MIN or 32 * (lay.k - 1) * lay.warps < s_len
        assert lay.warps == vc.WARPS or 32 * vc.K_MAX * (lay.warps - 1) < s_len
    for s_len in (0, vc.MAX_STATES + 1):
        with pytest.raises(ValueError):
            vc.viterbi_layout(s_len)
    for vocab in (1, 29, 44, 71, 128, 256, 512, 800, 880, 1000, 4096, 8000, 12000, 12287):
        top = _old_max_states(vocab)
        assert top <= vc.MAX_STATES
        for s_len in (*range(1, top + 1, 7), top):
            if s_len < 1:
                continue
            warps = vc.viterbi_layout(s_len).warps
            ring, smem = vc.viterbi_launch_smem(s_len, vocab, warps)
            assert smem <= 232448 and smem == vc.viterbi_smem_bytes(s_len, vocab, warps, ring)
            assert ring == (vc.viterbi_smem_bytes(s_len, vocab, warps) <= 232448), (s_len, vocab)
    # without the ring every S up to the limit fits, at any vocabulary
    for s_len in range(1, vc.MAX_STATES + 1):
        warps = vc.viterbi_layout(s_len).warps
        assert vc.viterbi_smem_bytes(s_len, 100000, warps, ring=False) <= 232448
