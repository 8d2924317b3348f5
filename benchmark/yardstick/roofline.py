"""The table of peaks, the least time of each kernel and the model FLOPs.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), at its 700 W
limit: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.
A share of a peak is stated beside the card's power limit.

The per-kernel counts are those of ``chip_smoke.py`` (``bound_ms`` and
the byte and operation counts of kernels 1-5), copied: a kernel's least
time is the larger of its operations over the FLOP peak and its bytes
over the bandwidth, with each input read once and each output written
once, and the work counted over the rows these lengths need.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def least_s(n_bytes: float, n_ops: float) -> float:
    """The least time of ``n_ops`` float32 operations on ``n_bytes``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_F32_FLOPS)


# -- kernels ------------------------------------------------------------------

def bilstm_infer_launch(batch: int, time: int, hidden: int, lengths: Sequence[int]) -> float:
    """Kernel 1's launch (both directions of a layer's recurrence): reads
    the gate inputs of the valid rows and W_hh, writes ``out [B, T, 2H]``;
    ``h W_hh^T`` is 8 H^2 operations a row and direction."""
    valid = int(np.sum(lengths))
    n_bytes = (2 * valid * 4 * hidden + 2 * 4 * hidden * hidden + batch * time * 2 * hidden) * F32
    return least_s(n_bytes, 2 * valid * 8 * hidden * hidden)


def bilstm_train_fwd_launch(batch: int, time: int, hidden: int, lengths: Sequence[int]) -> float:
    """Kernel 2's launch: kernel 1's work, and the saved states: reads the
    gate inputs and W_hh once, writes out, h_prev and c_prev
    (``[2, B, T, H]`` each)."""
    valid = int(np.sum(lengths))
    state = batch * time * 2 * hidden * F32
    n_bytes = 2 * valid * 4 * hidden * F32 + 2 * 4 * hidden * hidden * F32 + 3 * state
    return least_s(n_bytes, 2 * valid * 8 * hidden * hidden)


def bilstm_train_bwd_launches(batch: int, time: int, hidden: int,
                              lengths: Sequence[int]) -> float:
    """Kernel 3's two launches of a layer: the gate recompute and
    ``dG W_hh`` (16 H^2 a row and direction), reading the gate inputs, the
    states and dout, writing dG."""
    valid = int(np.sum(lengths))
    state = batch * time * 2 * hidden * F32
    n_bytes = 2 * valid * 7 * hidden * F32 + 2 * 4 * hidden * hidden * F32 + 4 * state
    return least_s(n_bytes, 2 * valid * 16 * hidden * hidden)


def _ctc_sizes(batch, time, label_pad, input_lengths, target_lengths):
    s_len = 2 * label_pad + 1
    active = int(np.sum(np.minimum(np.asarray(input_lengths), time)
                        * (2 * np.asarray(target_lengths) + 1)))
    lattice = time * batch * s_len * F32
    const = 3 * batch * s_len * F32 + batch * F32
    return s_len, active, lattice, const


def ctc_alpha_launch(batch, time, vocab, label_pad, input_lengths, target_lengths) -> float:
    """Kernel 4: reads log_probs and the lattice constants, writes alpha;
    about 10 operations a valid state of an active step."""
    _, active, lattice, const = _ctc_sizes(batch, time, label_pad, input_lengths, target_lengths)
    return least_s(batch * time * vocab * F32 + const + lattice, 10 * active)


def ctc_adjoint_launch(batch, time, vocab, label_pad, input_lengths, target_lengths) -> float:
    """Kernel 5: reads alpha, the seed and the constants, writes the adjoint."""
    s_len, active, lattice, const = _ctc_sizes(batch, time, label_pad, input_lengths,
                                               target_lengths)
    return least_s(2 * lattice + const + batch * s_len * F32, 10 * active)


# -- whole models (forward FLOPs over real frames) ----------------------------

def conv_out(length, kernel: int, stride: int, padding: int, transpose: bool):
    if transpose:
        return (np.asarray(length) - 1) * stride - 2 * padding + kernel
    return (np.asarray(length) + 2 * padding - kernel) // stride + 1


def _lstm_flops(frames, d_in: int, hidden: int, layers: int) -> float:
    total, d = 0.0, d_in
    for _ in range(layers):
        total += float(np.sum(frames)) * 2 * (2 * 4 * hidden * d + 2 * 4 * hidden * hidden)
        d = 2 * hidden
    return total


def asr_v2_forward_flops(init_args: dict, mel_frames) -> float:
    """AudioToAlignText's forward over clips of ``mel_frames`` real frames:
    the conv encoder, both directions of every biLSTM layer (projection
    and recurrence), the dense logits; 2 operations a multiply-add."""
    frames = np.asarray(mel_frames, np.int64)
    flops, c_in = 0.0, int(init_args["audio_size"])
    for c_out, transpose, k, s, p, _ in init_args["encoder_settings"]:
        frames = conv_out(frames, k, s, p, bool(transpose))
        flops += float(np.sum(frames)) * 2 * k * c_in * c_out
        c_in = c_out
    hidden = int(init_args["decoder_hidden_size"])
    flops += _lstm_flops(frames, c_in, hidden, int(init_args["decoder_num_layers"]))
    flops += float(np.sum(frames)) * 2 * 2 * hidden * int(init_args["vocab_size"])
    return flops


def tts_v2_forward_flops(init_args: dict, text_len) -> float:
    """AlignTextToAudio's forward over items of ``text_len`` real aligned
    tokens: the biLSTM, the decoder convs (a transposed conv costs its
    input frames times k C_in C_out) and the projection."""
    tokens = np.asarray(text_len, np.int64)
    hidden = int(init_args["encoder_hidden_size"])
    flops = _lstm_flops(tokens, hidden, hidden, int(init_args["encoder_num_layers"]))
    frames, c_in = tokens, 2 * hidden
    for c_out, transpose, k, s, p, _ in init_args["decoder_settings"]:
        out = conv_out(frames, k, s, p, bool(transpose))
        flops += float(np.sum(frames if transpose else out)) * 2 * k * c_in * c_out
        frames, c_in = out, c_out
    audio = 2 * init_args["f0_size"] + init_args["logspc_size"] + 2 * init_args["codeap_size"]
    return flops + float(np.sum(frames)) * 2 * c_in * audio


FORWARD_FLOPS = {"asr_v2": asr_v2_forward_flops, "tts_v2": tts_v2_forward_flops}


def train_flops(forward: float) -> float:
    """A training step's FLOPs: the forward and a backward of twice it
    (the input and the weight gradients)."""
    return 3.0 * forward
