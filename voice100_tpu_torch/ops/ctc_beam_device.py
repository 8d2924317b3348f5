"""Batched CTC prefix beam search on the device.

Port of ``voice100_tpu/ops/ctc_beam_device.py``, the same dynamic program
as the host decoder (``ops/ctc_beam.py``, Hannun et al. 2014) run on the
log-probs' device for a whole batch: a loop over frames, each frame one
set of tensor operations over ``[B, ...]``, with fixed-shape beam state,
so the host fetches only the decoded ``[B, T]`` ids. The JAX package runs
it as a ``lax.scan`` vmapped over the batch; it has no Pallas kernel, and
this port is plain PyTorch (``ROADMAP.md`` queue 2 keeps a hand kernel
for a later record).

* The beam holds ``beam_size`` prefixes as ``[K, T]`` id rows with the
  two-track mass (log P ending in blank, log P ending in a symbol).
* A prefix's identity in the merge is a pair of 32-bit polynomial
  rolling hashes updated on append. They are the JAX package's uint32
  arithmetic, computed in int64 and reduced modulo 2**32 after every
  product and sum (the products split into 16-bit halves so that no
  int64 product overflows), so the hashes are bit-equal to JAX's.
* Per frame only the ``topk`` most probable non-blank symbols extend a
  prefix (plus blank and each prefix's last symbol); ``topk >= V - 1``
  considers every symbol, the host decoder's unpruned set. The
  selections order equal values lower index first, as ``lax.top_k``
  does (a stable descending sort).
* Padded frames (``t >= length``) emit blank with log-probability 0, so
  padding never changes a decoded sequence.
* ``-1e30`` stands for minus infinity, and the log-add-exp clamps its
  difference, as in the JAX package.
* The prefixes' masses are summed in float64, as the host decoder's
  Python floats are (the JAX package sums in float32). On a flat output
  distribution two prefixes can lie within float32 rounding of each
  other, and float32 sums then rank them otherwise than the host decoder
  does: a random-weight model's clip of 8 s parts them
  (``tests/test_torch_beam.py``). On the tests' seeded draws the ids are
  JAX's all the same.
"""

from __future__ import annotations

import torch

__all__ = ["ctc_prefix_beam_search_batched"]

_NEG_INF = -1e30  # avoids -inf - -inf = nan inside log-add-exp and where

# the rolling hashes' constants (two independent channels: a merge
# collision needs both 32-bit hashes to collide on different contents)
_H_MULT1 = 1000003
_H_MULT2 = 2654435761
_H_EMPTY1 = 0x811C9DC5
_H_EMPTY2 = 0x01000193
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2**32`` for int64 ``h`` in [0, 2**32) without an int64
    overflow: the two 16-bit halves of ``h`` times ``m`` stay below 2**48."""
    low = (h & 0xFFFF) * m
    high = ((h >> 16) * m) & _MASK32
    return (low + (high << 16)) & _MASK32


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    # clamp so exp never sees (-1e30 - -1e30); the where keeps it exact
    d = torch.clamp((a - b).abs(), max=80.0)
    return torch.where(m <= _NEG_INF / 2, _NEG_INF, m + torch.log1p(torch.exp(-d)))


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, equal values in
    index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _masked_lse(values: torch.Tensor, eq: torch.Tensor) -> torch.Tensor:
    """For each candidate ``i``, the log-sum-exp of ``values`` over the
    candidates ``j`` with ``eq[i, j]`` (its duplicates and itself)."""
    vm = torch.where(eq, values[:, None, :], _NEG_INF)
    mx = vm.max(dim=-1).values
    s = torch.where(eq, torch.exp(vm - mx[..., None]), 0.0).sum(dim=-1)
    return torch.where(mx <= _NEG_INF / 2, _NEG_INF, mx + torch.log(s))


def ctc_prefix_beam_search_batched(log_probs, lengths, beam_size: int = 8, topk: int = 8,
                                   blank: int = 0, lm_table=None, lm_weight: float = 0.5,
                                   lm_bonus: float = 0.0):
    """Decode ``[B, T, V]`` log-softmax outputs on their device.

    Args:
        log_probs: per-frame log probabilities, padded on time (a tensor,
            or an array, which runs on the CPU).
        lengths: ``[B]`` valid frame counts.
        beam_size: prefixes kept per frame.
        topk: non-blank symbols considered as extensions per frame
            (``topk >= V - 1`` considers every symbol, the host decoder's
            unpruned candidate set).
        lm_table: optional dense trigram ``[V, V, V]`` log-prob table
            (``text/ngram.py``) for shallow fusion: every appended symbol
            adds ``lm_weight * log P_lm(s | c2, c1) + lm_bonus``, contexts
            starting at (blank, blank).
        lm_weight: fusion weight on the LM log prob per appended symbol.
        lm_bonus: constant per-symbol length bonus.

    Returns:
        ``(ids [B, T] int64, n [B] int64)`` on the log-probs' device: the
        best label sequence of each row (no blanks or CTC repeats; the
        first ``n`` ids are valid).
    """
    log_probs = torch.as_tensor(log_probs).to(torch.float64)
    dev = log_probs.device
    lengths = torch.as_tensor(lengths).to(dev)
    batch, t_max, vocab = log_probs.shape
    k = beam_size
    p = min(topk, vocab - 1)
    table = None
    if lm_table is not None:
        # the table's blank column is -inf by construction: clamp it
        table = torch.clamp(torch.as_tensor(lm_table).to(dev, torch.float64), min=_NEG_INF)

    # a frame of "certain blank" past each row's end
    pad_frame = torch.full((vocab,), _NEG_INF, dtype=torch.float64, device=dev)
    pad_frame[blank] = 0.0
    prefix = torch.zeros((batch, k, t_max), dtype=torch.int64, device=dev)
    plen = torch.zeros((batch, k), dtype=torch.int64, device=dev)
    last = torch.full((batch, k), -1, dtype=torch.int64, device=dev)
    p_b = torch.full((batch, k), _NEG_INF, dtype=torch.float64, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((batch, k), _NEG_INF, dtype=torch.float64, device=dev)
    ctx = torch.full((batch, k, 2), blank, dtype=torch.int64, device=dev)  # (c2, c1)
    # beam 0 holds the empty prefix; the other slots get distinct sentinel
    # hashes, so they never merge with a live prefix
    ks = torch.arange(k, dtype=torch.int64, device=dev)
    h1 = torch.where(ks == 0, _H_EMPTY1, _mul32(ks, 0x9E3779B9)).expand(batch, k)
    h2 = torch.where(ks == 0, _H_EMPTY2, (_mul32(ks, 0x85EBCA6B) + 1) & _MASK32
                     ).expand(batch, k)

    # the candidates: K prefixes themselves, then K * P extensions
    parent = torch.cat([ks, ks.repeat_interleave(p)])
    appended = torch.cat([torch.zeros(k, dtype=torch.bool, device=dev),
                          torch.ones(k * p, dtype=torch.bool, device=dev)])
    positions = torch.arange(t_max, device=dev)
    for t in range(t_max):
        frame = torch.where((t < lengths)[:, None], log_probs[:, t], pad_frame)
        total = _logaddexp(p_b, p_nb)
        lp_blank = frame[:, blank]
        # each beam's log prob of repeating its last symbol (empty: -inf)
        lp_last = torch.where(last >= 0, frame.gather(1, last.clamp(min=0)), _NEG_INF)
        # the top-P non-blank extension symbols, shared by the beams
        nb_frame = frame.clone()
        nb_frame[:, blank] = _NEG_INF
        ext_lp, ext_sym = _top_k(nb_frame, p)

        # the prefix itself: a blank, or a repeat of its last symbol
        a_pb = total + lp_blank[:, None]
        a_pnb = p_nb + lp_last
        # the prefix + each top-P symbol: [B, K, P]
        sym_b = ext_sym[:, None, :].expand(batch, k, p)
        is_rep = sym_b == last[:, :, None]
        b_pnb = torch.where(is_rep, p_b[:, :, None], total[:, :, None]) + ext_lp[:, None, :]
        if table is not None:
            # shallow fusion: each appended symbol pays or earns the LM
            # score and a constant bonus
            lm_row = table[ctx[..., 0], ctx[..., 1]]                  # [B, K, V]
            b_pnb = b_pnb + (lm_weight * lm_row.gather(2, sym_b) + lm_bonus)
        h1_b = (_mul32(h1[:, :, None], _H_MULT1) + sym_b + 2) & _MASK32
        h2_b = (_mul32(h2[:, :, None], _H_MULT2) + sym_b + 2) & _MASK32

        sym_c = torch.cat([torch.zeros_like(last), sym_b.reshape(batch, -1)], dim=1)
        pb_c = torch.cat([a_pb, torch.full((batch, k * p), _NEG_INF, dtype=torch.float64,
                                           device=dev)], dim=1)
        pnb_c = torch.cat([a_pnb, b_pnb.reshape(batch, -1)], dim=1)
        h1_c = torch.cat([h1, h1_b.reshape(batch, -1)], dim=1)
        h2_c = torch.cat([h2, h2_b.reshape(batch, -1)], dim=1)

        # merge candidates of one content (equal hashes): each sums its
        # duplicates' mass, and only the first occurrence survives
        eq = (h1_c[:, :, None] == h1_c[:, None, :]) & (h2_c[:, :, None] == h2_c[:, None, :])
        pb_m = _masked_lse(pb_c, eq)
        pnb_m = _masked_lse(pnb_c, eq)
        first = eq.to(torch.int32).cumsum(dim=2).diagonal(dim1=1, dim2=2) == 1
        total_m = torch.where(first, _logaddexp(pb_m, pnb_m), _NEG_INF)

        _, keep = _top_k(total_m, k)
        par = parent[keep]
        app = appended[keep]
        sym_k = sym_c.gather(1, keep)
        plen_par = plen.gather(1, par)
        write = (positions[None, None, :] == plen_par[:, :, None]) & app[:, :, None]
        prefix = torch.where(write, sym_k[:, :, None],
                             prefix.gather(1, par[:, :, None].expand(batch, k, t_max)))
        plen = plen_par + app.to(torch.int64)
        last = torch.where(app, sym_k, last.gather(1, par))
        ctx_par = ctx.gather(1, par[:, :, None].expand(batch, k, 2))
        ctx = torch.where(app[:, :, None], torch.stack([ctx_par[..., 1], sym_k], dim=-1),
                          ctx_par)
        p_b, p_nb = pb_m.gather(1, keep), pnb_m.gather(1, keep)
        h1, h2 = h1_c.gather(1, keep), h2_c.gather(1, keep)

    best = torch.argmax(_logaddexp(p_b, p_nb), dim=1)
    rows = torch.arange(batch, device=dev)
    return prefix[rows, best], plen[rows, best]
