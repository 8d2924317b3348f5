"""ConformerCTC's work from its shapes and lengths: the model's forward
FLOPs over real frames (``mfu.conformer``) and kernel 9's least time
(``relpos_attention_roofline.conformer``), against the peaks of
``roofline.py`` (67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s).

FLOPs count 2 a multiply-add, over each row's real frames: the
subsampling's two convs (kernel 3 x 3, stride 2; the first from one
channel) and its linear; in every block the two FFNs, the q, k, v and
output projections, the positional projection over the ``2 L' - 1``
relative positions of the batch's longest row, the attention core over
the valid pairs (three dot products of a head's size a pair and head),
the conv module (two pointwise, the depthwise) and the decoder. A
training step is three forwards (``roofline.train_flops``).

Kernel 9's least time for one layer and step: forward, three dot
products of D = 64 a valid pair and head (``q.k``, ``q.p``, ``P.v``);
backward, six (``dO.v`` and the products that give dV, dK, dQu, dQv and
dp; the probabilities' recomputation is left out, as an algorithm that
kept them would not do it). Bytes: each input read once and each output
written once: q, k, v and out (and their gradients) over the real rows,
the projected positions of the longest row, lse and Delta, the keep mask
over the valid pairs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import roofline

F32 = 4


def subsampled(frames, n_convs: int = 2):
    """NeMo's ``calc_length`` for kernel 3, stride 2, padding 1, once a conv."""
    out = np.asarray(frames, np.int64)
    for _ in range(n_convs):
        out = (out - 1) // 2 + 1
    return out


def forward_flops(init_args: dict, mel_frames) -> float:
    """ConformerCTC's forward over clips of ``mel_frames`` real frames."""
    frames = np.asarray(mel_frames, np.int64)
    d = int(init_args["d_model"])
    e = int(init_args["ff_expansion_factor"])
    k = int(init_args["conv_kernel_size"])
    bins = int(init_args["audio_size"])
    vocab = int(init_args["vocab_size"])
    layers = int(init_args["n_layers"])
    t1, f1 = subsampled(frames, 1), int(subsampled(bins, 1))
    t2, f2 = subsampled(frames, 2), int(subsampled(bins, 2))
    n1, n2 = float(np.sum(t1)), float(np.sum(t2))
    flops = n1 * f1 * 2 * 9 * d + n2 * f2 * 2 * 9 * d * d + n2 * 2 * d * f2 * d
    per_frame = (2 * 2 * 2 * d * e * d      # two FFNs
                 + 4 * 2 * d * d            # q, k, v, out
                 + 2 * d * 2 * d + 2 * k * d + 2 * d * d)  # conv module
    positions = 2 * float(np.max(t2)) - 1
    attention = 3 * 2 * d * float(np.sum(t2.astype(np.float64) ** 2))
    flops += layers * (n2 * per_frame + positions * 2 * d * d + attention)
    return flops + n2 * 2 * d * vocab


def attention_least_s(batch: int, time: int, heads: int, head_dim: int,
                      lengths: Sequence[int]) -> float:
    """Kernel 9's least time, forward and backward, of one layer at
    ``[batch, time]`` subsampled frames with these row lengths."""
    lengths = np.asarray(lengths, np.int64)
    pairs = heads * float(np.sum(lengths.astype(np.float64) ** 2))
    rows = float(np.sum(lengths)) * heads * head_dim * F32
    positions = (2 * float(np.max(lengths)) - 1) * heads * head_dim * F32
    stats = batch * heads * time * F32
    fwd_bytes = 4 * rows + positions + stats + pairs
    bwd_bytes = 9 * rows + 2 * positions + 2 * stats + pairs
    ops = (3 + 6) * 2 * head_dim * pairs
    return roofline.least_s(fwd_bytes + bwd_bytes, ops)
