"""Masked losses of the TTS models: the WORLD losses and the duration loss.

Port of ``voice100_tpu/models/losses.py`` (the reference's WORLDLoss v2,
voice100/models/_layers_v2.py:106-161, WORLDLoss v1 with its mel
weights, voice100/models/_layers_v1.py:37-93, and the masked
log-duration L1 loss, voice100/models/_align_v2.py:86-95). Every stream
is cropped to the common time length of prediction and target
(:func:`adjust_size`), then masked by the target lengths; each loss is a
masked sum over the mask's sum (at least 1). Inside
:func:`voice100_tpu_torch.parallel.mesh.global_batch` the mask's sum is
the global batch's (:func:`~voice100_tpu_torch.parallel.mesh.global_sum`),
so the ranks' losses add up to the global batch's loss.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.mask import sequence_mask
from ..parallel.mesh import global_sum

__all__ = ["WORLDLossValues", "world_loss_v2", "world_loss_v1", "mel_logspc_weights",
           "duration_loss", "adjust_size"]


def adjust_size(x: torch.Tensor, y: torch.Tensor):
    """Crop both tensors to their common time length (axis 1)."""
    n = min(x.shape[1], y.shape[1])
    return x[:, :n], y[:, :n]


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise stable BCE-with-logits (torch's BCEWithLogitsLoss form)."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _err(loss: str):
    """The elementwise error of ``loss``: ``"l1"``, else the squared error."""
    if loss == "l1":
        return lambda a, b: (a - b).abs()
    return lambda a, b: (a - b) ** 2


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
    err = _err(loss)
    hasf0_logits, hasf0 = adjust_size(hasf0_logits, hasf0)
    f0_hat, f0 = adjust_size(f0_hat, f0)
    logspc_hat, logspc = adjust_size(logspc_hat, logspc)
    hascodeap_logits, hascodeap = adjust_size(hascodeap_logits, hascodeap)
    codeap_hat, codeap = adjust_size(codeap_hat, codeap)

    mask = sequence_mask(length.to(f0.device), f0.shape[1], dtype=f0.dtype)
    mask_sum = torch.clamp(global_sum(mask.sum()), min=1.0)
    return WORLDLossValues(
        (_bce_with_logits(hasf0_logits, hasf0) * mask).sum() / mask_sum,
        (err(f0_hat, f0) * hasf0 * mask).sum() / mask_sum,
        (err(logspc_hat, logspc).mean(dim=2) * mask).sum() / mask_sum,
        (_bce_with_logits(hascodeap_logits, hascodeap).mean(dim=2) * mask).sum() / mask_sum,
        ((err(codeap_hat, codeap) * hascodeap).mean(dim=2) * mask).sum() / mask_sum,
    )


def mel_logspc_weights(sample_rate: int, n_fft: int) -> np.ndarray:
    """Mel-scale weights of the ``n_fft // 2 + 1`` spectral bins, summing
    to 1 (reference _layers_v1.py:60-65), float32."""
    f = (sample_rate / n_fft) * np.arange(n_fft // 2 + 1)
    dm = 1127.0 / (700.0 + f)
    return (dm / dm.sum()).astype(np.float32)


def world_loss_v1(length, hasf0_logits, f0_hat, logspc_hat, codeap_hat, hasf0, f0, logspc,
                  codeap, logspc_weights=None, loss: str = "mse"):
    """The v1 WORLD losses ``(hasf0, f0, logspc, codeap)`` (reference
    _layers_v1.py:69-93): as :func:`world_loss_v2` without the hascodeap
    term, and codeap unmasked by it. With ``logspc_weights [S]`` the
    spectrum's error is a weighted **sum** over the bins; without, a
    mean."""
    err = _err(loss)
    hasf0_logits, hasf0 = adjust_size(hasf0_logits, hasf0)
    f0_hat, f0 = adjust_size(f0_hat, f0)
    logspc_hat, logspc = adjust_size(logspc_hat, logspc)
    codeap_hat, codeap = adjust_size(codeap_hat, codeap)

    mask = sequence_mask(length.to(f0.device), f0.shape[1], dtype=f0.dtype)
    mask_sum = torch.clamp(global_sum(mask.sum()), min=1.0)
    e = err(logspc_hat, logspc)
    if logspc_weights is not None:
        per_frame = (e * logspc_weights[None, None, :]).sum(dim=2)
    else:
        per_frame = e.mean(dim=2)
    return ((_bce_with_logits(hasf0_logits, hasf0) * mask).sum() / mask_sum,
            (err(f0_hat, f0) * hasf0 * mask).sum() / mask_sum,
            (per_frame * mask).sum() / mask_sum,
            (err(codeap_hat, codeap).mean(dim=2) * mask).sum() / mask_sum)


def duration_loss(pred: torch.Tensor, align: torch.Tensor, text: torch.Tensor,
                  text_len: torch.Tensor) -> torch.Tensor:
    """Masked L1 between ``pred [B, L, 2]`` (log domain) and
    ``log(1 + align)`` of the target frame counts ``align [B, L, 2]``,
    masked by ``text_len`` over ``text``'s length."""
    logalign = torch.log1p(align.to(pred.dtype))
    per_tok = (logalign - pred).abs().mean(dim=2)                  # [B, L]
    mask = sequence_mask(text_len.to(pred.device), text.shape[1], dtype=pred.dtype)
    return (per_tok * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)
