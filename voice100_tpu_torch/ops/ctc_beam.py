"""CTC prefix beam search (host-side decoder).

A host copy of ``voice100_tpu/ops/ctc_beam.py`` (NumPy only). Greedy
decoding collapses per-frame argmaxes, which merges distinct prefixes
that share surface form and drops mass split across alignments; prefix
beam search sums alignment probabilities per *output prefix* (Hannun et
al. 2014) and is strictly better when the model is uncertain. This runs
on the host over the device-computed log-probs, one utterance at a time
(``ASRPipeline(beam_device=False)``); ``ops/ctc_beam_device.py`` runs the
same dynamic program batched on the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ctc_prefix_beam_search"]

_NEG_INF = -np.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == _NEG_INF:
        return b
    if b == _NEG_INF:
        return a
    m = a if a > b else b
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    beam_size: int = 8,
    blank: int = 0,
    prune_log_prob: float = -12.0,
    lm_table=None,
    lm_weight: float = 0.5,
    lm_bonus: float = 0.0,
) -> List[int]:
    """Decode ``[T, V]`` log-probs to the most probable label sequence.

    Args:
        log_probs: per-frame log-softmax outputs (valid frames only).
        beam_size: number of prefixes kept per frame.
        prune_log_prob: per-frame tokens below this log-prob are not
            considered as extensions (keeps the inner loop short).
        lm_table: optional dense trigram ``[V, V, V]`` log-prob table
            (text/ngram.py); every appended symbol's score adds
            ``lm_weight * log P_lm(s | c2, c1) + lm_bonus`` (shallow
            fusion, identical math to the device decoder's).

    Returns:
        The best prefix as a list of label ids (no blanks/repeats).
    """
    log_probs = np.asarray(log_probs)
    # beams: prefix(tuple) -> (log p ending in blank, log p ending in
    # its last symbol)
    beams: Dict[Tuple[int, ...], Tuple[float, float]] = {
        (): (0.0, _NEG_INF)
    }
    for t in range(log_probs.shape[0]):
        frame = log_probs[t]
        candidates = np.nonzero(frame > prune_log_prob)[0]
        if candidates.size == 0:
            candidates = np.asarray([int(frame.argmax())])
        next_beams: Dict[Tuple[int, ...], Tuple[float, float]] = {}

        def add(prefix, p_b, p_nb):
            old_b, old_nb = next_beams.get(prefix, (_NEG_INF, _NEG_INF))
            next_beams[prefix] = (
                _logsumexp2(old_b, p_b), _logsumexp2(old_nb, p_nb)
            )

        for prefix, (p_b, p_nb) in beams.items():
            total = _logsumexp2(p_b, p_nb)
            last = prefix[-1] if prefix else None
            if lm_table is not None:
                c2 = prefix[-2] if len(prefix) >= 2 else blank
                c1 = last if last is not None else blank
                lm_row = lm_table[c2, c1]

            def ext(s, lp):
                if lm_table is None:
                    return lp
                return lp + lm_weight * float(lm_row[s]) + lm_bonus

            for s in candidates:
                s = int(s)
                lp = float(frame[s])
                if s == blank:
                    add(prefix, total + lp, _NEG_INF)
                elif s == last:
                    # repeat extends the non-blank path of the same
                    # prefix; a new occurrence needs a blank before it
                    add(prefix, _NEG_INF, p_nb + lp)
                    add(prefix + (s,), _NEG_INF, p_b + ext(s, lp))
                else:
                    add(prefix + (s,), _NEG_INF, total + ext(s, lp))

        beams = dict(sorted(
            next_beams.items(),
            key=lambda kv: _logsumexp2(*kv[1]),
            reverse=True,
        )[:beam_size])

    best = max(beams.items(), key=lambda kv: _logsumexp2(*kv[1]))[0]
    return list(best)
