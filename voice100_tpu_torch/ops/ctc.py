"""CTC loss, plain PyTorch: the log-semiring lattice and its adjoint.

Port of ``voice100_tpu/ops/ctc.py:105-217`` and of the semantics of the
Pallas lattice kernels (``voice100_tpu/ops/ctc_pallas.py:56-191``):
blank 0, the ``[B, 2L+1]`` blank-interleaved lattice, per-sample input
and target lengths, ``reduction`` mean (each sample's loss divided by
``max(target_len, 1)``, then the batch mean), sum or none, and
``zero_infinity`` (a loss ``>= 5e29`` becomes 0, and so does its
gradient). Impossible states carry the finite sentinel ``-1e30``, not
``-inf``: ``(-inf) - (-inf)`` would give NaN in the log-sum-exp.

:func:`ctc_alpha` and :func:`ctc_alpha_adjoint` are the plain versions
of the CUDA kernels (``ops/ctc_cuda.py``), whose wrappers run them for
tensors on the CPU. :func:`ctc_loss` here differentiates the plain
lattice with autograd; the training path uses
:func:`voice100_tpu_torch.ops.ctc_cuda.ctc_loss_cuda`, whose backward is
the adjoint kernel.

CTC Viterbi forced alignment (``voice100_tpu/ops/ctc.py:220-336``) is
split into the plain twins of its two kernels (``ops/viterbi_cuda.py``):
:func:`viterbi_forward`, the max-semiring lattice recording the move
into each state, and :func:`viterbi_backtrace`, the walk back from the
final state that :func:`viterbi_final` picks between them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.mesh import global_batch_active, global_sum

__all__ = ["NEG_INF", "ctc_prep", "ctc_alpha", "ctc_alpha_adjoint", "ll_from_alpha",
           "reduce_loss", "ctc_loss", "ViterbiResult", "check_viterbi_args", "viterbi_forward",
           "viterbi_final", "viterbi_backtrace", "ctc_viterbi_align"]

NEG_INF = -1e30


def ctc_prep(targets: torch.Tensor, target_lengths: torch.Tensor):
    """The lattice constants (``ctc_pallas.py:159-190``, without the lane
    padding): ``z [B, S]`` int64, the blank-interleaved labels
    (``S = 2L + 1``); ``can_skip [B, S]`` bool, ``z_s != 0 and
    z_s != z_{s-2}``; ``valid [B, S]`` bool, ``s < 2 * target_len + 1``."""
    batch, label_len = targets.shape
    s_len = 2 * label_len + 1
    z = targets.new_zeros(batch, s_len, dtype=torch.int64)
    z[:, 1::2] = targets
    z_prev2 = torch.cat([z.new_zeros(batch, 2), z], dim=1)[:, :s_len]
    can_skip = (z != 0) & (z != z_prev2)
    s_idx = torch.arange(s_len, device=targets.device)
    valid = s_idx[None, :] < (2 * target_lengths.to(targets.device)[:, None] + 1)
    return z, can_skip, valid


def _lse3(a0, a1, a2):
    m = torch.maximum(torch.maximum(a0, a1), a2)
    m_safe = torch.clamp(m, min=NEG_INF)
    return m_safe + torch.log(torch.exp(a0 - m_safe) + torch.exp(a1 - m_safe)
                              + torch.exp(a2 - m_safe))


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a[:, s - k]``, ``NEG_INF`` for ``s < k`` (any ``S``, 1 included)."""
    return torch.cat([a.new_full((a.shape[0], k), NEG_INF), a], dim=1)[:, :a.shape[1]]


def _left(a: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """``a[:, s + k]``, ``fill`` for ``s + k >= S`` (any ``S``, 1 included)."""
    return torch.cat([a[:, k:], a.new_full((a.shape[0], k), fill)], dim=1)[:, :a.shape[1]]


def ctc_alpha(log_probs: torch.Tensor, z: torch.Tensor, can_skip: torch.Tensor,
              valid: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """The forward lattice ``alpha [T, B, S]`` (kernel 4's plain version;
    ``_fwd_kernel``, ``ctc_pallas.py:64-86``).

    ``alpha[0]`` is the emission of the first two states (where valid);
    step ``t >= 1`` takes the 3-way log-sum-exp of ``alpha[t-1]`` at
    ``s``, ``s-1`` and, where ``can_skip``, ``s-2``, adds the emission
    ``log_probs[b, t, z_s]``, sets invalid states to ``NEG_INF``, and
    holds the row unchanged once ``t >= input_lengths[b]``.
    ``log_probs`` is ``[B, T, V]`` float32.
    """
    batch, time, _ = log_probs.shape
    s_len = z.shape[1]
    lp_z = torch.gather(log_probs, 2, z[:, None, :].expand(batch, time, s_len))  # [B, T, S]
    first2 = torch.arange(s_len, device=z.device)[None, :] < 2
    alpha = torch.where(first2 & valid, lp_z[:, 0], NEG_INF)
    active = torch.arange(time, device=z.device)[:, None] < input_lengths.to(z.device)[None, :]
    rows = [alpha]
    for t in range(1, time):
        a2 = torch.where(can_skip, _shift(alpha, 2), NEG_INF)
        new = _lse3(alpha, _shift(alpha, 1), a2) + lp_z[:, t]
        new = torch.where(valid, new, NEG_INF)
        alpha = torch.where(active[t][:, None], new, alpha)
        rows.append(alpha)
    return torch.stack(rows)


def ctc_alpha_adjoint(alpha: torch.Tensor, g_seed: torch.Tensor, can_skip: torch.Tensor,
                      valid: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """dLL/d``lp_z`` ``[T, B, S]``, the exact adjoint of :func:`ctc_alpha`
    seeded with ``g_seed = dLL/d alpha[T-1]`` ``[B, S]`` (kernel 5's plain
    version; ``_bwd_kernel``, ``ctc_pallas.py:88-156``).

    Walks ``t`` from ``T-1`` down: an active step emits its masked
    adjoint ``g`` and carries it to ``alpha[t-1]`` through the
    log-sum-exp weights ``exp(min(alpha[t-1](s) - pre(s + k), 0))``,
    ``k = 0, 1, 2`` (``k = 2`` where ``can_skip(s + 2)``), ``pre`` being
    the step's log-sum-exp recomputed from ``alpha[t-1]``; a held step
    emits 0 and passes ``g`` on. Step 0 emits ``g`` on the first two
    states only.
    """
    time = alpha.shape[0]
    s_len = alpha.shape[2]
    active = torch.arange(time, device=alpha.device)[:, None] < input_lengths.to(alpha.device)[None, :]
    first2 = torch.arange(s_len, device=alpha.device)[None, :] < 2
    skip2 = _left(can_skip, 2, False)
    g = g_seed
    rows = [None] * time
    for t in range(time - 1, 0, -1):
        a = alpha[t - 1]
        on = active[t][:, None]
        pre = _lse3(a, _shift(a, 1), torch.where(can_skip, _shift(a, 2), NEG_INF))
        pre_safe = torch.clamp(pre, min=NEG_INF)
        ge = torch.where(on & valid, g, 0.0)
        rows[t] = ge
        g_new = ge * torch.exp(torch.clamp(a - pre_safe, max=0.0))
        for k, gate in ((1, None), (2, skip2)):
            term = _left(ge, k, 0.0) * torch.exp(torch.clamp(a - _left(pre_safe, k, 0.0), max=0.0))
            g_new = g_new + (term if gate is None else torch.where(gate, term, 0.0))
        g = torch.where(on, g_new, g)
    rows[0] = torch.where(first2 & valid, g, 0.0)
    return torch.stack(rows)


def ll_from_alpha(alpha_last: torch.Tensor, target_lengths: torch.Tensor):
    """Per-sample log-likelihood from the last lattice row ``[B, S]``:
    the log-sum-exp of the final blank ``2L`` and the last label
    ``2L - 1`` (absent when ``L = 0``). Returns ``(ll, a_last, a_prev)``
    (``ctc_pallas.py:291-300``)."""
    end = 2 * target_lengths.to(alpha_last.device).long()
    a_last = alpha_last.gather(1, end[:, None])[:, 0]
    a_prev = alpha_last.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(end > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    ll = m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))
    return ll, a_last, a_prev


def reduce_loss(ll: torch.Tensor, target_lengths: torch.Tensor, reduction: str = "mean",
                zero_infinity: bool = True) -> torch.Tensor:
    """``-ll`` with ``zero_infinity`` and the reduction
    (``voice100_tpu/ops/ctc.py:146-154``). Inside
    :func:`voice100_tpu_torch.parallel.mesh.global_batch` the mean is
    this rank's share of the global batch's mean: the ranks' means add up
    to it."""
    loss = -ll
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF / 2, 0.0, loss)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")
    mean = (loss / target_lengths.to(loss.device).clamp(min=1).to(loss.dtype)).mean()
    if global_batch_active():
        # this rank's share of the global batch's mean: its rows' mean times
        # its part of the rows (exactly 1.0 on one rank)
        rows = loss.new_full((), float(loss.shape[0]))  # filled on the device: no upload
        mean = mean * (rows / global_sum(rows))
    return mean


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
             target_lengths: torch.Tensor, blank: int = 0, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """Batched CTC negative log-likelihood, differentiable by autograd.

    ``log_probs [B, T, V]`` (log-softmax outputs; the lattice runs in
    float32), ``targets [B, L]`` padded label ids, ``input_lengths`` and
    ``target_lengths [B]``. ``blank`` must be 0, as for the JAX kernels.
    """
    if blank != 0:
        raise ValueError("the CTC lattice takes blank 0 only")
    z, can_skip, valid = ctc_prep(targets, target_lengths)
    alpha = ctc_alpha(log_probs.float(), z, can_skip, valid, input_lengths)
    ll, _, _ = ll_from_alpha(alpha[-1], target_lengths)
    return reduce_loss(ll, target_lengths, reduction, zero_infinity).to(log_probs.dtype)


class ViterbiResult(NamedTuple):
    score: torch.Tensor   # [B] best path log-prob
    path: torch.Tensor    # [B, T] int32 position in the blank-interleaved lattice
    labels: torch.Tensor  # [B, T] int32 label id per frame (the aligned text)


def check_viterbi_args(blank: int, max_move: int) -> None:
    """The Viterbi takes the JAX kernels' rule only: blank 0 and
    ``max_move=3`` (``voice100_tpu/ops/ctc.py:244-245``)."""
    if blank != 0:
        raise ValueError(f"the CTC Viterbi takes blank 0 only, got {blank}")
    if max_move != 3:
        raise ValueError(f"the CTC Viterbi takes max_move=3 only, got {max_move}")


def viterbi_forward(log_probs: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                    input_lengths: torch.Tensor):
    """Max-semiring forward (kernel 6's plain version; ``_vit_fwd_kernel``,
    ``ctc_pallas.py:405-437``). Returns ``(moves [T, B, S] uint8,
    alpha_last [B, S] float32)``.

    ``alpha[0]`` is the emission of the first two states (where valid).
    Step ``t >= 1`` picks, per state, the best of ``alpha[t-1]`` at ``s``,
    ``s-1`` and ``s-2`` (moves 0, 1, 2); a 2-move may not land on a blank,
    the shifts fill with ``NEG_INF``, and the updates are strict ``>`` in
    the order 0, 1, 2, so ties go to the smallest move. It adds the
    emission ``log_probs[b, t, z_s]``, sets invalid states to ``NEG_INF``
    and, once ``t >= input_lengths[b]``, holds the row and records move 0.
    ``moves[t]`` is the move into ``t``; ``moves[0]`` is 0.
    """
    batch, time, _ = log_probs.shape
    s_len = z.shape[1]
    lp_z = torch.gather(log_probs, 2, z[:, None, :].expand(batch, time, s_len))  # [B, T, S]
    first2 = torch.arange(s_len, device=z.device)[None, :] < 2
    is_blank = z == 0
    alpha = torch.where(first2 & valid, lp_z[:, 0], NEG_INF)
    active = torch.arange(time, device=z.device)[:, None] < input_lengths.to(z.device)[None, :]
    moves = torch.zeros(time, batch, s_len, dtype=torch.uint8, device=z.device)
    for t in range(1, time):
        best, move = alpha, torch.zeros_like(moves[t])
        for k, cand in ((1, _shift(alpha, 1)),
                        (2, torch.where(is_blank, NEG_INF, _shift(alpha, 2)))):
            better = cand > best
            best = torch.where(better, cand, best)
            move = torch.where(better, k, move)
        new = torch.where(valid, best + lp_z[:, t], NEG_INF)
        on = active[t][:, None]
        alpha = torch.where(on, new, alpha)
        moves[t] = torch.where(on, move, 0)
    return moves, alpha


def viterbi_final(alpha_last: torch.Tensor, target_lengths: torch.Tensor):
    """The final state and the score (``ctc_pallas.py:526-534``): the
    last blank ``2L`` only when its score is strictly greater than that
    of the last label ``2L - 1`` (clamped at 0 for ``L = 0``), else the
    last label. Returns ``(final_pos [B] int64, score [B])``."""
    end = 2 * target_lengths.to(alpha_last.device).long()
    prev = (end - 1).clamp(min=0)
    a_last = alpha_last.gather(1, end[:, None])[:, 0]
    a_prev = alpha_last.gather(1, prev[:, None])[:, 0]
    take_last = a_last > a_prev
    return torch.where(take_last, end, prev), torch.where(take_last, a_last, a_prev)


def viterbi_backtrace(moves: torch.Tensor, final_pos: torch.Tensor, input_lengths: torch.Tensor,
                      z: torch.Tensor):
    """The best path from the moves (kernel 7's plain version;
    ``_vit_bt_kernel``, ``ctc_pallas.py:440-460, 559-564``): from
    ``final_pos`` at ``T-1`` walk ``pos_{t-1} = pos_t - moves[t, b, pos_t]``
    (held steps record move 0, so the walk stays put past each length).
    Returns ``(path, labels)``, ``[B, T]`` int32, ``labels = z[path]``,
    both zeroed from each input length on."""
    time, batch, _ = moves.shape
    pos = final_pos.to(moves.device).long()
    path = torch.zeros(batch, time, dtype=torch.int64, device=moves.device)
    for t in range(time - 1, -1, -1):
        path[:, t] = pos
        # a move never passes state 0 (the shifts fill with NEG_INF and
        # ties keep move 0); the clamp keeps the index in range regardless
        pos = (pos - moves[t].gather(1, pos[:, None])[:, 0].long()).clamp(min=0)
    frames = torch.arange(time, device=moves.device)[None, :]
    in_frame = frames < input_lengths.to(moves.device)[:, None]
    path = torch.where(in_frame, path, 0)
    labels = torch.where(in_frame, z.to(moves.device).gather(1, path), 0)
    return path.int(), labels.int()


def ctc_viterbi_align(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
                      target_lengths: torch.Tensor, blank: int = 0,
                      max_move: int = 3) -> ViterbiResult:
    """Batched CTC forced alignment, plain PyTorch (``ctc.py:226-336``):
    ``log_probs [B, T, V]`` (the lattice runs in float32), ``targets
    [B, L]``, lengths ``[B]``. Per frame the lattice position advances 0,
    1 or 2 slots and a 2-slot advance may not land on a blank; frames from
    each input length on are zeroed."""
    check_viterbi_args(blank, max_move)
    z, _, valid = ctc_prep(targets, target_lengths)
    moves, alpha_last = viterbi_forward(log_probs.float(), z, valid, input_lengths)
    final_pos, score = viterbi_final(alpha_last, target_lengths)
    path, labels = viterbi_backtrace(moves, final_pos, input_lengths, z)
    return ViterbiResult(score, path, labels)
