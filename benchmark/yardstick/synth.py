"""Seeded inputs and weights: everything a run feeds the program.

The run's ``--seed`` picks the order and the content; the multiset of
sizes comes from the traffic file's own ``size_seed``, so that every seed
gives the program the same amount of work in another order. Bulk data is
drawn on the run's device with a ``torch.Generator`` in a few large
calls and copied to the host once.

The clip and target shapes follow ``chip_smoke.py`` (``int16_clips``,
``ctc_targets``, ``voiced_clip``), copied here so that the benchmark
never imports the program's tools.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

SAMPLE_RATE = 16000
HOP = 160            # samples a log-mel frame (10 ms)
WORLD_FRAME_S = 0.01  # a WORLD frame
BLANK_AUDIO = math.log(1e-6)


def _entropy(seed: int, keys) -> List[int]:
    return [int(seed) % 2**64, *[int(k) % 2**64 for k in keys]]


def np_rng(seed: int, *keys) -> np.random.Generator:
    """A numpy generator for one purpose (``keys``) of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, keys)))


def torch_seed(seed: int, *keys) -> int:
    """A 63-bit seed for a ``torch.Generator``, one per purpose."""
    state = np.random.SeedSequence(_entropy(seed, keys)).generate_state(1, np.uint64)[0]
    return int(state) & (2**63 - 1)


def torch_gen(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(torch_seed(seed, *keys))


# -- sizes ------------------------------------------------------------------

def draw_seconds(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` clip lengths in seconds from a mixture (``spec["components"]``,
    each ``{"weight", "normal": [mean, std]}``, ``"uniform": [lo, hi]`` or
    ``"lognormal": [mu, sigma]``), redrawn until inside ``spec["range"]``."""
    lo, hi = spec["range"]
    comps = spec["components"]
    weights = np.asarray([c["weight"] for c in comps], np.float64)
    weights /= weights.sum()
    out = np.empty(n)
    todo = np.arange(n)
    while len(todo):
        which = rng.choice(len(comps), size=len(todo), p=weights)
        vals = np.empty(len(todo))
        for k, comp in enumerate(comps):
            sel = which == k
            m = int(sel.sum())
            if "normal" in comp:
                vals[sel] = rng.normal(*comp["normal"], size=m)
            elif "uniform" in comp:
                vals[sel] = rng.uniform(*comp["uniform"], size=m)
            elif "lognormal" in comp:
                vals[sel] = rng.lognormal(*comp["lognormal"], size=m)
            else:
                raise ValueError(f"unknown length component {comp}")
        ok = (vals >= lo) & (vals <= hi)
        out[todo[ok]] = vals[ok]
        todo = todo[~ok]
    return out


def pool_seconds(traffic: dict, n: int) -> np.ndarray:
    """The pool's clip lengths: the same multiset for every run seed."""
    return draw_seconds(np_rng(int(traffic["size_seed"]), 1), traffic["seconds"], n)


# -- weights ----------------------------------------------------------------

def _fill_plan(model: torch.nn.Module):
    """``(param, kind, bound)`` for every parameter: torch's default
    initialisation by module type (uniform within 1/sqrt(fan_in); LSTM
    tensors within 1/sqrt(H); embeddings normal; LayerNorm 1 and 0)."""
    plan, seen = [], set()
    for module in model.modules():
        own = list(module.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(module, torch.nn.LayerNorm):
            kinds = {"weight": ("one", 0.0), "bias": ("zero", 0.0)}
        elif isinstance(module, torch.nn.Embedding):
            kinds = {"weight": ("normal", 1.0)}
        elif isinstance(module, torch.nn.ConvTranspose1d):
            b = 1.0 / math.sqrt(module.out_channels // module.groups * module.kernel_size[0])
            kinds = {"weight": ("uniform", b), "bias": ("uniform", b)}
        elif isinstance(module, torch.nn.Conv1d):
            b = 1.0 / math.sqrt(module.in_channels // module.groups * module.kernel_size[0])
            kinds = {"weight": ("uniform", b), "bias": ("uniform", b)}
        elif isinstance(module, torch.nn.Linear):
            b = 1.0 / math.sqrt(module.in_features)
            kinds = {"weight": ("uniform", b), "bias": ("uniform", b)}
        else:  # the biLSTM: weight_hh_l0 is [4H, H]
            hidden = getattr(module, "hidden_size", None)
            if hidden is None:
                raise ValueError(f"no initialisation rule for {type(module).__name__}")
            b = 1.0 / math.sqrt(hidden)
            kinds = {name: ("uniform", b) for name, _ in own}
        for name, p in own:
            if id(p) not in seen:
                seen.add(id(p))
                plan.append((p, *kinds[name]))
    return plan


@torch.no_grad()
def fill_weights(model: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Overwrite every parameter of ``model`` from ``seed`` on its device:
    one uniform and one normal draw for the whole model. Returns copies of
    the weights by name, for the reference."""
    device = next(model.parameters()).device
    plan = _fill_plan(model)
    gen = torch_gen(device, seed, 11)
    n_uni = sum(p.numel() for p, kind, _ in plan if kind == "uniform")
    n_norm = sum(p.numel() for p, kind, _ in plan if kind == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_norm, generator=gen, device=device)
    iu = inn = 0
    for p, kind, bound in plan:
        n = p.numel()
        if kind == "uniform":
            p.copy_((uni[iu:iu + n] * bound).view_as(p))
            iu += n
        elif kind == "normal":
            p.copy_(nrm[inn:inn + n].view_as(p))
            inn += n
        else:
            p.fill_(1.0 if kind == "one" else 0.0)
    return {name: p.detach().clone() for name, p in model.named_parameters()}


# -- data -------------------------------------------------------------------

def _segments(lengths: Sequence[int], device):
    """Per position of a concatenation of items: the item index and the
    position inside it."""
    lengths = torch.as_tensor(np.asarray(lengths, np.int64), device=device)
    item = torch.repeat_interleave(torch.arange(len(lengths), device=device), lengths)
    starts = torch.cumsum(lengths, 0) - lengths
    return item, torch.arange(int(lengths.sum()), device=device) - starts[item]


def _split(flat: np.ndarray, lengths: Sequence[int]) -> List[np.ndarray]:
    return np.split(flat, np.cumsum(np.asarray(lengths, np.int64))[:-1])


def int16_clips(seconds: Sequence[float], gen: torch.Generator, device) -> List[np.ndarray]:
    """Noise bursts under a slow envelope as 16 kHz int16 PCM (the shape
    of ``chip_smoke.py``'s ``int16_clips``), one clip a length."""
    n = [int(s * SAMPLE_RATE) for s in seconds]
    item, pos = _segments(n, device)
    freq = torch.rand(len(n), generator=gen, device=device) * 2.5 + 0.5
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * freq[item] * pos / SAMPLE_RATE)
    noise = torch.randn(len(item), generator=gen, device=device)
    pcm = (noise * 4000.0 * env).clamp(-32768, 32767).to(torch.int16)
    return _split(pcm.cpu().numpy(), n)


def mel_frames(samples) -> np.ndarray:
    """Log-mel frames of clips of ``samples`` (centred STFT, hop 160)."""
    return np.asarray(samples) // HOP + 1


def logmel_items(frames: Sequence[int], gen: torch.Generator, device) -> List[np.ndarray]:
    """Seeded float16 log-mel items ``[frames, 64]``, as the port's feature
    cache holds them: a slow spectral tilt plus noise, within the range of
    real log-mel features (the blank level log(1e-6) to about 4)."""
    item, pos = _segments(frames, device)
    tilt = torch.rand(len(frames), generator=gen, device=device) * 4.0 - 6.0
    bands = torch.linspace(0.0, -3.0, 64, device=device)
    noise = torch.randn(len(item), 64, generator=gen, device=device) * 2.0
    x = (tilt[item][:, None] + bands[None, :] + noise).clamp(BLANK_AUDIO, 4.0)
    return _split(x.to(torch.float16).cpu().numpy(), frames)


def ctc_texts(seconds: Sequence[float], rate: float, vocab: int, rng) -> List[np.ndarray]:
    """Transcripts of ``rate`` ids a second (ids 1..vocab-1; 0 is the blank)."""
    lengths = np.maximum(np.round(np.asarray(seconds) * rate).astype(np.int64), 1)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in lengths]


def world_items(frames: Sequence[int], gen: torch.Generator, device, mcep: int = 25,
                codeap: int = 1):
    """Seeded WORLD targets, one ``(f0 [T], mcep [T, mcep], codeap [T, codeap])``
    an item: f0 in 80-300 Hz along a slow contour, zero on unvoiced
    stretches (about a third of the frames); mel-cepstra with a falling
    scale; coded aperiodicity in (-3, 0]."""
    item, pos = _segments(frames, device)
    k = len(frames)
    rate = torch.rand(k, generator=gen, device=device) * 1.2 + 0.3
    phase = torch.rand(k, generator=gen, device=device) * 2 * math.pi
    vrate = torch.rand(k, generator=gen, device=device) * 1.5 + 0.5
    t = pos.to(torch.float32) * WORLD_FRAME_S
    f0 = 190.0 + 110.0 * torch.sin(2 * math.pi * rate[item] * t + phase[item])
    voiced = torch.sin(2 * math.pi * vrate[item] * t + 3 * phase[item]) > -0.5
    f0 = torch.where(voiced, f0, 0.0)
    scale = torch.exp(-torch.arange(mcep, device=device, dtype=torch.float32) / 8.0) * 2.0
    mc = torch.randn(len(item), mcep, generator=gen, device=device) * scale
    mc[:, 0] -= 4.0
    cap = -3.0 * torch.rand(len(item), codeap, generator=gen, device=device)
    f0, mc, cap = (a.cpu().numpy() for a in (f0, mc, cap))
    return list(zip(_split(f0, frames), _split(mc, frames), _split(cap, frames)))


def aligned_texts(frames: Sequence[int], vocab: int, rng) -> List[np.ndarray]:
    """Aligned ids at 20 ms a token (two WORLD frames), blanks included."""
    return [rng.integers(0, vocab, size=int(-(-int(n) // 2))).astype(np.int32) for n in frames]


def wav_bytes(pcm: np.ndarray, rate: int = SAMPLE_RATE) -> bytes:
    """Mono 16-bit PCM as a RIFF WAV body."""
    payload = np.asarray(pcm, "<i2").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
    return header + b"data" + struct.pack("<I", len(payload)) + payload
