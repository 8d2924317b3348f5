"""Masked losses of the v2 TTS models: the WORLD loss and the duration loss.

Port of ``voice100_tpu/models/losses.py:27-86,136-157`` (the reference's
WORLDLoss v2, voice100/models/_layers_v2.py:106-161, and the masked
log-duration L1 loss, voice100/models/_align_v2.py:86-95). Every stream
is cropped to the common time length of prediction and target
(:func:`adjust_size`), then masked by the target lengths; each loss is a
masked sum over the mask's sum (at least 1). The v1 loss and its mel
weights wait for the v1 models (``ROADMAP.md`` queue 1, item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.mask import sequence_mask

__all__ = ["WORLDLossValues", "world_loss_v2", "duration_loss", "adjust_size"]


def adjust_size(x: torch.Tensor, y: torch.Tensor):
    """Crop both tensors to their common time length (axis 1)."""
    n = min(x.shape[1], y.shape[1])
    return x[:, :n], y[:, :n]


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise stable BCE-with-logits (torch's BCEWithLogitsLoss form)."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


class WORLDLossValues(NamedTuple):
    hasf0: torch.Tensor
    f0: torch.Tensor
    logspc: torch.Tensor
    hascodeap: torch.Tensor
    codeap: torch.Tensor


def world_loss_v2(length, hasf0_logits, f0_hat, logspc_hat, hascodeap_logits, codeap_hat,
                  hasf0, f0, logspc, hascodeap, codeap, loss: str = "mse") -> WORLDLossValues:
    """Per-stream masked losses: BCE of the voicing logits, ``loss``
    (``"mse"`` or ``"l1"``) of f0 on voiced frames, of the spectrum, and
    of codeap where it is aperiodic; masked by ``length`` over the cropped
    time axis."""
    if loss == "l1":
        def err(a, b):
            return (a - b).abs()
    else:
        def err(a, b):
            return (a - b) ** 2
    hasf0_logits, hasf0 = adjust_size(hasf0_logits, hasf0)
    f0_hat, f0 = adjust_size(f0_hat, f0)
    logspc_hat, logspc = adjust_size(logspc_hat, logspc)
    hascodeap_logits, hascodeap = adjust_size(hascodeap_logits, hascodeap)
    codeap_hat, codeap = adjust_size(codeap_hat, codeap)

    mask = sequence_mask(length.to(f0.device), f0.shape[1], dtype=f0.dtype)
    mask_sum = torch.clamp(mask.sum(), min=1.0)
    return WORLDLossValues(
        (_bce_with_logits(hasf0_logits, hasf0) * mask).sum() / mask_sum,
        (err(f0_hat, f0) * hasf0 * mask).sum() / mask_sum,
        (err(logspc_hat, logspc).mean(dim=2) * mask).sum() / mask_sum,
        (_bce_with_logits(hascodeap_logits, hascodeap).mean(dim=2) * mask).sum() / mask_sum,
        ((err(codeap_hat, codeap) * hascodeap).mean(dim=2) * mask).sum() / mask_sum,
    )


def duration_loss(pred: torch.Tensor, align: torch.Tensor, text: torch.Tensor,
                  text_len: torch.Tensor) -> torch.Tensor:
    """Masked L1 between ``pred [B, L, 2]`` (log domain) and
    ``log(1 + align)`` of the target frame counts ``align [B, L, 2]``,
    masked by ``text_len`` over ``text``'s length."""
    logalign = torch.log1p(align.to(pred.dtype))
    per_tok = (logalign - pred).abs().mean(dim=2)                  # [B, L]
    mask = sequence_mask(text_len.to(pred.device), text.shape[1], dtype=pred.dtype)
    return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
