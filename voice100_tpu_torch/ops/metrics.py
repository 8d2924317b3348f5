"""Text error-rate metrics (host-side).

A copy of ``voice100_tpu/ops/metrics.py``: the edit distance and the
corpus-level edit counts behind the trainer's validation CER and WER
(greedy decode -> tokenizer decode -> merge_repeated, the reference
runtime's decode flow).
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["levenshtein", "error_rate"]


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (insert/delete/substitute)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (ca != cb),  # substitution
            ))
        prev = cur
    return prev[-1]


def error_rate(refs: Sequence[Sequence], hyps: Sequence[Sequence]) -> Tuple[int, int]:
    """Corpus-level (edits, reference_length) over paired sequences;
    rate = edits / max(reference_length, 1)."""
    edits = total = 0
    for ref, hyp in zip(refs, hyps):
        edits += levenshtein(ref, hyp)
        total += len(ref)
    return edits, total
