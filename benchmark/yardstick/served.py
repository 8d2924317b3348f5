"""What the served ASR cells share: the clip pool, the capture of what
``ASRPipeline`` produced, and its comparison with the reference.

The capture wraps two methods of the pipeline instance, both on the host
side of the timed path: ``batches`` (which clips went into a batch, and
its padded width) and ``_text`` (the frame ids a row was fetched with and
the text made of them). It adds no device work and no sync.
"""

from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from . import compare, roofline, synth


class Capture:
    """Per pipeline call: its batches ``(clip positions, width)`` and each
    row's ``(ids, n, text)``; one call at a time (the micro-batcher's
    worker or the closed-loop client)."""

    def __init__(self, pipe) -> None:
        self._current: Optional[dict] = None
        orig_batches, orig_text = pipe.batches, pipe._text

        def batches(waveforms):
            for chunk, wav, lengths in orig_batches(waveforms):
                if self._current is not None:
                    self._current["batches"].append((list(chunk), int(wav.shape[1])))
                yield chunk, wav, lengths

        def _text(out, n):
            text = orig_text(out, n)
            if self._current is not None:
                self._current["rows"].append((out[:n], int(n), text))
            return text

        pipe.batches, pipe._text = batches, _text

    def begin(self, clips) -> None:
        self._current = {"clips": clips, "batches": [], "rows": []}

    def end(self, texts) -> dict:
        call, self._current = self._current, None
        call["texts"] = texts
        return call

    def clip_rows(self, call: dict):
        """``(clip position, width, ids, n, text the row made)`` in the
        order the pipeline fetched them."""
        order = [(pos, width) for chunk, width in call["batches"] for pos in chunk]
        for (pos, width), (ids, n, text) in zip(order, call["rows"]):
            yield pos, width, ids, n, text


def make_pool(rc, n: int) -> List[np.ndarray]:
    """``n`` int16 clips whose lengths are the mix's multiset for every
    seed; the run's seed orders them and draws their content."""
    sizes = synth.pool_seconds(rc.traffic, n)
    rng = synth.np_rng(rc.seed, 40)
    return synth.int16_clips(sizes[rng.permutation(n)], synth.torch_gen(rc.device, rc.seed, 41),
                             rc.device)


def forward_flops(init_args, clips) -> float:
    return roofline.asr_v2_forward_flops(
        init_args, synth.mel_frames(np.asarray([len(c) for c in clips])))


def infer_calls(init_args, batch: int, width: int, clips) -> list:
    """Kernel 1's launches of one served batch: ``(B, T', H, lengths)`` a
    layer, the lengths of the clips after the conv encoder."""
    frames = synth.mel_frames(np.asarray([len(c) for c in clips]))
    t_out = int(synth.mel_frames(width))
    for _, tp, k, s, p, _ in init_args["encoder_settings"]:
        frames = roofline.conv_out(frames, k, s, p, bool(tp))
        t_out = int(roofline.conv_out(t_out, k, s, p, bool(tp)))
    hidden = int(init_args["decoder_hidden_size"])
    return [(batch, t_out, hidden, frames)] * int(init_args["decoder_num_layers"])


def _reference(rc, weights):
    return importlib.import_module(f"reference.{rc.config['reference']}").ASRReference(
        rc.init_args, weights)


def _by_width(rows, block: int):
    """Blocks of at most ``block`` rows of one padded width."""
    by_width = defaultdict(list)
    for row in rows:
        by_width[row[1]].append(row)
    for width, group in sorted(by_width.items()):
        for start in range(0, len(group), block):
            yield width, group[start:start + block]


def check_rows(rc, weights, rows, block: int = 64) -> Dict[str, float]:
    """Compare served rows ``(clip int16, width, ids, n)`` with the reference
    at their padded widths, in blocks of rows of one width. Returns the
    widest gap and the count of rows whose length is not the reference's."""
    common = importlib.import_module("reference.common")
    ref = _reference(rc, weights)
    gap, bad_len = 0.0, 0
    for width, part in _by_width(rows, block):
        with common.precision("float32"):
            logits, lengths = ref.served_logits([r[0] for r in part], width, rc.device)
        for j, ((_, _, ids, n), length) in enumerate(zip(part, lengths.tolist())):
            if int(length) != int(n):
                bad_len += 1
                continue
            gap = max(gap, compare.served_gap(ids, logits[j, :n]))
    return {"logit_gap": gap, "length_mismatch": float(bad_len)}


def stand_in_rows(rc, weights, rows, mode: str, block: int = 64) -> list:
    """The rows with the frame ids and lengths the reference computed in
    ``mode`` puts first at each frame of the same clips: a stand-in's
    answers in the program's place."""
    common = importlib.import_module("reference.common")
    ref = _reference(rc, weights)
    out = []
    for width, part in _by_width(rows, block):
        with common.precision(mode):
            logits, lengths = ref.served_logits([r[0] for r in part], width, rc.device)
        ids = logits.argmax(-1).cpu().numpy()
        for j, (row, length) in enumerate(zip(part, lengths.tolist())):
            out.append((row[0], width, ids[j, :length], int(length)))
    return out


def sample_rows(rows: list, k: int, rng: np.random.Generator) -> list:
    """A seeded sample of ``k`` rows (``(clip, ...)`` tuples), the longest
    clip among them."""
    if len(rows) <= k:
        return list(rows)
    longest = max(range(len(rows)), key=lambda i: len(rows[i][0]))
    rest = [i for i in range(len(rows)) if i != longest]
    pick = [longest] + list(rng.choice(rest, size=k - 1, replace=False))
    return [rows[i] for i in pick]
