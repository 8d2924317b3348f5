"""Batch spectrogram augmentation, plain PyTorch.

Port of ``voice100_tpu/ops/augment.py:37-118`` (the reference's
BatchSpectrogramAugumentation), split in two so that a test can feed
the JAX package's draws to the port:

* :func:`draw_augment` draws every random quantity from a
  ``torch.Generator``, on the generator's device;
* :func:`apply_augment` applies them.

The transforms run in the JAX order, each behind a coin of probability
0.2 (``AUGMENT_RATE``) and shared across the batch: time stretch (the
padded length stays; the sequence shrinks or grows inside it), pitch
shift, amplitude shift, up to three time masks, one frequency mask, mixed
noise; then exactly one of mixaudio (a 0.9/0.1 blend with the next row
of the batch, ``roll(shift=-1)``) or maskaudio, both re-masking the
padding to the blank level ``log(1e-6)``. Integer draws keep the JAX
bounds, exclusive at the top (``randint(50, 150)`` and the others).
Everything stays on the device: no draw is read back by the host.

A rank of a data-parallel run
(:func:`voice100_tpu_torch.parallel.mesh.global_batch`) draws the noise
for the global batch and keeps its own rows, and its last row blends with
the next rank's first: its rows come out as one process's global batch
gives them.

:func:`draw_spec_augment` and :func:`apply_spec_augment` are NeMo's
``SpecAugment`` for the Conformer-CTC model (``conformer_ctc_bpe.yaml``:
2 frequency masks of width at most 27, 10 time masks of width at most
0.05 of each row's length, masked to 0), drawn on the device: one
``torch.rand`` of ``[B, 24]`` uniforms a batch, turned into NeMo's
inclusive integer ranges (a frequency mask starts in ``[0, F - W]`` and
is ``[0, W]`` wide, ``W = min(27, F)``; a time mask of a row of length
``L`` starts in ``[0, max(1, L - w)]`` and is ``[0, w]`` wide,
``w = max(1, floor(0.05 L))``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.mesh import own_rows_of_draw, roll_rows
from .mask import BLANK_AUDIO
from .melspec import LOG_OFFSET

__all__ = ["AUGMENT_RATE", "draw_augment", "apply_augment", "SPEC_FREQ_MASKS", "SPEC_FREQ_WIDTH",
           "SPEC_TIME_MASKS", "SPEC_TIME_WIDTH", "draw_spec_augment", "apply_spec_augment"]

AUGMENT_RATE = 0.2
_N_TIME_MASKS = 3
SPEC_FREQ_MASKS, SPEC_FREQ_WIDTH = 2, 27
SPEC_TIME_MASKS, SPEC_TIME_WIDTH = 10, 0.05

Draws = Dict[str, torch.Tensor]


def draw_augment(generator: torch.Generator, batch: int, time: int, dim: int) -> Draws:
    """Every draw of one augmented batch ``[batch, time, dim]``, as
    tensors on ``generator.device``: coins (bool), integers (int64) and
    uniforms (float32)."""
    device = generator.device

    def coin():
        return torch.rand((), generator=generator, device=device) < AUGMENT_RATE

    def uniform(lo, hi, shape=()):
        # jax.random.uniform's rule, clamped below at lo: the mask values'
        # (lo, hi) = (-log(1e-6), -5) then always give lo
        u = torch.rand(shape, generator=generator, device=device)
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    def randint(lo, hi, shape=()):
        return torch.randint(lo, hi, shape, generator=generator, device=device)

    return {
        "stretch_coin": coin(), "stretch_rate": randint(50, 150),
        "pitch_coin": coin(), "pitch_rate": 1.0 + uniform(0.0, 0.2),
        "amp_coin": coin(), "amp": 1.0 + uniform(0.0, 3.0),
        "tmask_coin": coin(), "tmask_n": randint(1, _N_TIME_MASKS + 1),
        "tmask_center": randint(0, time, (_N_TIME_MASKS,)),
        "tmask_hw": randint(1, 4, (_N_TIME_MASKS,)),
        "tmask_val": uniform(-BLANK_AUDIO, -5.0, (_N_TIME_MASKS,)),
        "fmask_coin": coin(), "fmask_center": randint(0, dim), "fmask_hw": randint(1, 11),
        "fmask_val": uniform(-BLANK_AUDIO, -5.0),
        "noise_coin": coin(), "noise_low": -5.0 + 5.0 * uniform(0.0, 1.0),
        "noise_high": -5.0 + 5.0 * uniform(0.0, 1.0), "noise_std": 5.0 * uniform(0.0, 1.0),
        "noise": own_rows_of_draw(lambda shape: uniform(0.0, 1.0, shape), (batch, time, dim)),
        "mix_coin": coin(),
    }


def apply_augment(audio: torch.Tensor, audio_len: torch.Tensor, draws: Draws):
    """Augment ``[B, T, D]`` log-mel ``audio`` with lengths ``[B]`` by
    ``draws`` (:func:`draw_augment`); returns ``(audio, audio_len)``."""
    _, time, dim = audio.shape
    device = audio.device
    d = {k: v.to(device) for k, v in draws.items()}

    # time stretch (audio.py:52-58)
    rate = d["stretch_rate"]
    t_idx = torch.arange(time, device=device)
    src = torch.clamp(t_idx * 100 // rate, 0, time - 1)
    # a clamp, not a minimum with a new device scalar: uploading that scalar
    # would make the host wait for the card
    new_len = torch.clamp(audio_len * rate // 100, max=time)
    audio = torch.where(d["stretch_coin"], audio.index_select(1, src), audio)
    audio_len = torch.where(d["stretch_coin"], new_len.to(audio_len.dtype), audio_len)

    # pitch shift: squeeze the mel axis (audio.py:60-64)
    f_idx = torch.arange(dim, device=device)
    src = torch.clamp((f_idx.to(torch.float32) * d["pitch_rate"]).to(torch.int64), 0, dim - 1)
    audio = torch.where(d["pitch_coin"], audio.index_select(2, src), audio)

    # amplitude shift (audio.py:66-68)
    audio = torch.where(d["amp_coin"], audio - d["amp"], audio)

    # time masks (audio.py:70-80)
    masked = audio
    for m in range(_N_TIME_MASKS):
        center, hw = d["tmask_center"][m], d["tmask_hw"][m]
        band = (t_idx >= center - hw) & (t_idx < center + hw) & (m < d["tmask_n"])
        masked = torch.where(band[None, :, None], d["tmask_val"][m], masked)
    audio = torch.where(d["tmask_coin"], masked, audio)

    # frequency mask (audio.py:82-90)
    band = (f_idx >= d["fmask_center"] - d["fmask_hw"]) & (f_idx < d["fmask_center"] + d["fmask_hw"])
    audio = torch.where(d["fmask_coin"] & band[None, None, :], d["fmask_val"], audio)

    # mixed noise (audio.py:92-98)
    # linspace(low, high, dim) as jnp.linspace computes it
    step = torch.arange(dim, device=device, dtype=torch.float32) / max(dim - 1, 1)
    scale = d["noise_low"] * (1.0 - step) + d["noise_high"] * step
    scale[-1] = d["noise_high"]
    noise = d["noise"] * d["noise_std"] + scale
    mixed = torch.log(torch.clamp(torch.exp(audio) + torch.exp(noise), min=LOG_OFFSET))
    audio = torch.where(d["noise_coin"], mixed, audio)

    # mixaudio or maskaudio, one of which always runs (audio.py:100-108)
    mask = (t_idx[None, :, None] < audio_len[:, None, None]).to(audio.dtype)
    x = torch.exp(audio) * mask
    rolled = roll_rows(x)
    mixed = torch.log(torch.clamp((0.9 * x + 0.1 * rolled) * mask, min=LOG_OFFSET))
    masked = torch.log(torch.clamp(x, min=LOG_OFFSET))
    return torch.where(d["mix_coin"], mixed, masked), audio_len


def draw_spec_augment(generator: torch.Generator, batch: int) -> Draws:
    """SpecAugment's draws of one batch: ``[batch, 2 (SPEC_FREQ_MASKS +
    SPEC_TIME_MASKS)]`` uniforms on ``generator.device``, one call."""
    n = 2 * (SPEC_FREQ_MASKS + SPEC_TIME_MASKS)
    return {"spec": torch.rand(batch, n, generator=generator, device=generator.device)}


def _below(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``floor(u n)`` for uniforms ``u`` in [0, 1): an integer in ``[0, n)``."""
    return torch.minimum((u * n).floor(), n - 1)


def apply_spec_augment(audio: torch.Tensor, audio_len: torch.Tensor, draws: Draws) -> torch.Tensor:
    """``[B, T, F]`` features with SpecAugment's masks (:func:`draw_spec_augment`)
    set to 0; lengths do not change. The integer bounds are taken in
    float64, as NeMo's Python does."""
    _, time, dim = audio.shape
    dev = audio.device
    u = draws["spec"].to(dev, torch.float64)
    nf = SPEC_FREQ_MASKS
    width = float(min(SPEC_FREQ_WIDTH, dim))
    f_start = _below(u[:, :nf], torch.tensor(dim - width + 1.0, dtype=torch.float64, device=dev))
    f_width = _below(u[:, nf:2 * nf], torch.tensor(width + 1.0, dtype=torch.float64, device=dev))
    length = audio_len.to(dev, torch.float64)[:, None]
    t_max = torch.clamp((length * SPEC_TIME_WIDTH).floor(), min=1.0)
    t_start = _below(u[:, 2 * nf:2 * nf + SPEC_TIME_MASKS],
                     torch.clamp(length - t_max, min=1.0) + 1)
    t_width = _below(u[:, 2 * nf + SPEC_TIME_MASKS:], t_max + 1)
    f_idx = torch.arange(dim, device=dev, dtype=torch.float64)[None, None, :]
    t_idx = torch.arange(time, device=dev, dtype=torch.float64)[None, None, :]
    f_band = ((f_idx >= f_start[:, :, None]) & (f_idx < (f_start + f_width)[:, :, None])).any(1)
    t_band = ((t_idx >= t_start[:, :, None]) & (t_idx < (t_start + t_width)[:, :, None])).any(1)
    return audio.masked_fill(f_band[:, None, :] | t_band[:, :, None], 0.0)
