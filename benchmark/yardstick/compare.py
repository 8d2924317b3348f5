"""The numbers that decide ``correct``, each held to a limit of its own.

Training: each step's loss against the reference's, the first gradient
(as Adam holds it after one step: its first moment over 1 - b1) and the
parameters' change after the checked steps, both by the worst leaf: the
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change.

Serving: the widest gap by which a served token's logit lies below the
reference's best at its frame, over a seeded sample of the requests
answered, the longest among them; each answer's length and text must be
its own request's.
"""

from __future__ import annotations

import re
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

CHARACTERS = "_ abcdefghijklmnopqrstuvwxyz'"  # blank first (voice100's 29 symbols)
_REPEATED = re.compile(r"(.)\1+")
FLAT_GRADIENT = 1e-3


def greedy_text(ids: Sequence[int]) -> str:
    """Frame ids -> text: symbols, repeats collapsed, blanks dropped."""
    text = "".join(CHARACTERS[int(i)] for i in ids if 0 <= int(i) < len(CHARACTERS))
    text = _REPEATED.sub(r"\1", text).replace(CHARACTERS[0], "")
    return "" if text == " " else text


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's ``| |prog| - |ref| | / max(|ref|, median |ref|)``
    and its name."""
    names = sorted(ref if leaves is None else leaves)
    p, r = _norms({n: prog[n] for n in names}), _norms({n: ref[n] for n in names})
    med = statistics.median(r.values())
    worst, leaf = 0.0, ""
    for n in names:
        gap = abs(p[n] - r[n]) / max(r[n], med, 1e-30)
        if gap >= worst:
            worst, leaf = gap, n
    return worst, leaf


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = _norms(ref_grads)
    med = statistics.median(norms.values())
    return sorted(n for n, v in norms.items() if v >= FLAT_GRADIENT * med)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of the steps' losses."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def served_gap(ids: np.ndarray, ref_logits: torch.Tensor) -> float:
    """Over a clip's frames: how far the served token's reference logit
    lies below the reference's best."""
    ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, ids_t[:, None])[:, 0]
    return float((best - got).max()) if len(ids_t) else 0.0


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit; correct when every one is within."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
