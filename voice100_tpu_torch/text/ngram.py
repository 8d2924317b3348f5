"""Character/phone n-gram language model for CTC beam fusion.

A host copy of ``voice100_tpu/text/ngram.py`` (NumPy only): the same
estimation and the same ``.npz`` file, so a model either package saves
loads in the other. The whole model is one dense ``[V, V, V]``
log-probability table (vocab <= 71, so at most ~1.4 MB float32) that the
batched beam search (``ops/ctc_beam_device.py``) keeps on the device and
gathers for each extension candidate.

Estimation is Witten-Bell interpolated Kneser-style backoff
(parameter-free): P(s|a,b) interpolates the trigram ML estimate with
the bigram/unigram levels, each level weighted by its context's
novelty (distinct continuation types vs. tokens). Token id 0 is the
CTC blank, which never appears inside a label sequence, so slot 0 is
reused as the begin-of-sequence context.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

__all__ = ["CharNgramLM", "BOS"]

BOS = 0  # CTC blank id doubles as the BOS context marker


class CharNgramLM:
    """Dense trigram LM over tokenizer ids.

    ``table[a, b, s] = log P(s | a, b)`` with ``a``/``b`` the previous
    two ids (0 = sequence start). Rows are proper distributions over
    the non-blank vocabulary; column 0 (emitting blank) is -inf.
    """

    def __init__(self, table: np.ndarray) -> None:
        assert table.ndim == 3 and table.shape[0] == table.shape[1]
        self.table = table.astype(np.float32)

    @property
    def vocab_size(self) -> int:
        return self.table.shape[2]

    # ------------------------------------------------------------------
    @classmethod
    def fit(cls, sequences: Iterable[Sequence[int]],
            vocab_size: int) -> "CharNgramLM":
        """Estimate from tokenized sequences (ids in [1, vocab_size))."""
        v = vocab_size
        uni = np.zeros(v, np.float64)
        bi = {}
        tri = {}
        for seq in sequences:
            ctx = (BOS, BOS)
            for s in seq:
                s = int(s)
                if not 0 < s < v:
                    continue
                uni[s] += 1
                bi.setdefault(ctx[1], np.zeros(v, np.float64))[s] += 1
                tri.setdefault(ctx, np.zeros(v, np.float64))[s] += 1
                ctx = (ctx[1], s)
        if uni.sum() == 0:
            raise ValueError("no training tokens")

        def wb(counts: np.ndarray, lower: np.ndarray) -> np.ndarray:
            """Witten-Bell: interpolate ML(counts) with the lower-order
            distribution; the context's weight grows with its token
            count relative to its novelty (distinct continuations)."""
            n = counts.sum()
            t = np.count_nonzero(counts)
            if n == 0:
                return lower
            lam = n / (n + t)
            return lam * counts / n + (1.0 - lam) * lower

        # unigram smoothed against uniform over the non-blank vocab
        uniform = np.zeros(v, np.float64)
        uniform[1:] = 1.0 / (v - 1)
        p_uni = wb(uni, uniform)

        p_bi = np.tile(p_uni, (v, 1))
        for b, counts in bi.items():
            p_bi[b] = wb(counts, p_uni)

        table = np.empty((v, v, v), np.float32)
        for a in range(v):
            table[a] = p_bi  # default: back off to the bigram level
        for (a, b), counts in tri.items():
            table[a, b] = wb(counts, p_bi[b])

        with np.errstate(divide="ignore"):
            log_table = np.log(table, dtype=np.float32)
        log_table[:, :, 0] = -np.inf  # blank is never a label
        return cls(log_table)

    @classmethod
    def fit_texts(cls, texts: Iterable[str], tokenizer) -> "CharNgramLM":
        """Convenience: fit from raw phonemized strings."""
        seqs: List[List[int]] = [list(tokenizer(t)) for t in texts]
        return cls.fit(seqs, vocab_size=tokenizer.vocab_size)

    # ------------------------------------------------------------------
    def score(self, ids: Sequence[int]) -> float:
        """Log probability of a full id sequence (for tests/rescoring)."""
        total = 0.0
        ctx = (BOS, BOS)
        for s in ids:
            total += float(self.table[ctx[0], ctx[1], int(s)])
            ctx = (ctx[1], int(s))
        return total

    def save(self, path: str) -> None:
        np.savez_compressed(path, table=self.table)

    @classmethod
    def load(cls, path: str) -> "CharNgramLM":
        with np.load(path) as f:
            return cls(f["table"])
