"""CTC Viterbi forced alignment: the wrapper of ``csrc/viterbi.cu``.

:func:`viterbi_align_lattice_cuda` makes one launch that replaces the TPU
kernels ``voice100_tpu/ops/ctc_pallas.py::_vit_fwd_kernel`` and
``::_vit_bt_kernel`` and the choice of the final state between them (all
three wrapped by ``ctc_viterbi_pallas``, ``ctc_pallas.py:464-565``).
:func:`ctc_viterbi_align_cuda` is the whole alignment through it, with
the arguments and results of the plain
:func:`voice100_tpu_torch.ops.ctc.ctc_viterbi_align`.

The lattice runs in float32. The kernel gathers the emissions
``log_probs[b, t, z_s]`` itself and keeps the moves as its scratch,
packed 2 bits a state (:func:`pack_moves` and :func:`unpack_moves` are
the plain versions of that layout). For tensors on the CPU the wrappers
run the plain versions of :mod:`voice100_tpu_torch.ops.ctc`; for CUDA
tensors they launch the kernel or raise, and never fall back.
:func:`viterbi_align_lattice_cuda` counts its launches in its
``launches`` attribute.

Limits: a block of ``WARPS`` warps (one a scheduler of the SM) walks a
sample, ``k`` lattice states a lane, up to ``K_MAX``; larger lattices take
more warps (:func:`viterbi_layout`), so ``S = 2L + 1 <= MAX_STATES``
(3072, labels up to 1535), which the backtrace's stage of a byte a state
fits in shared memory. Past it the wrappers raise ``ValueError`` before
anything is loaded or launched. Any vocabulary runs: the kernel stages
two 32-step chunks of ``log_probs`` rows in shared memory where they fit
(up to about 830 classes at the largest S, 880 at S = 321) and otherwise reads each
step's emissions from device memory (:func:`viterbi_smem_bytes`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..kernels.build import check, load
from .ctc import (
    ViterbiResult, check_viterbi_args, ctc_prep, ctc_viterbi_align, viterbi_backtrace,
    viterbi_final, viterbi_forward,
)

__all__ = ["MAX_STATES", "WARPS", "CHUNK", "ViterbiLayout", "viterbi_layout",
           "viterbi_smem_bytes", "viterbi_launch_smem", "pack_moves", "unpack_moves", "viterbi_align_lattice_cuda",
           "ctc_viterbi_align_cuda"]

# csrc/viterbi.cu's K_MIN, K_MAX, MAX_WARPS, MAX_STATES and CH; the C entry
# refuses a layout or a shared-memory size other than these give
K_MIN, K_MAX, MAX_WARPS, MAX_STATES = 2, 16, 6, 3072
CHUNK = 32
# warps a sample below 32 * WARPS * K_MAX states: one a scheduler of the SM
WARPS = 4
# the opt-in dynamic shared memory of one block on sm_90
_SMEM_LIMIT = 232448
_P, _I = ctypes.c_void_p, ctypes.c_int


class ViterbiLayout(NamedTuple):
    k: int                   # lattice states a lane
    warps: int               # warps a sample (a block)
    words: int               # 32-bit words of moves a step: one a lane


def viterbi_layout(s_len: int) -> ViterbiLayout:
    """How the kernel covers ``s_len`` lattice states: ``WARPS`` warps a
    sample, more where ``K_MAX`` states a lane do not cover ``s_len``,
    then the fewest states a lane (at least ``K_MIN``). Raises
    ``ValueError`` past ``MAX_STATES``."""
    if not 1 <= s_len <= MAX_STATES:
        raise ValueError(f"viterbi: {s_len} lattice states do not fit the kernel (1 to "
                         f"{MAX_STATES})")
    warps = max(WARPS, -(-s_len // (32 * K_MAX)))
    k = max(K_MIN, -(-s_len // (32 * warps)))
    return ViterbiLayout(k, warps, 32 * warps)


def viterbi_smem_bytes(s_len: int, vocab: int, warps: int, ring: bool = True) -> int:
    """Dynamic shared memory of a launch of ``warps`` warps a sample
    (``smem_bytes`` of ``viterbi.cu``): the warps' exchange slots (16
    bytes, two halves of ``CHUNK + 1`` a warp) and z, then the larger of
    the emission ring (two chunks of ``log_probs`` rows; none if not
    ``ring``) and the last row with two chunks of the backtrace's byte
    stage, which reuse the ring."""
    row = 4 * (-(-s_len // 4) * 4)
    stage = 2 * CHUNK * (-(-s_len // 16) * 16)
    rows = 4 * 2 * CHUNK * vocab if ring else 0
    return 16 * warps * 2 * (CHUNK + 1) + row + max(rows, row + stage)


def viterbi_launch_smem(s_len: int, vocab: int, warps: int) -> tuple[bool, int]:
    """``(ring, bytes)`` of a launch: the emission ring where its shared
    memory fits a block's opt-in limit, else none (each lane reads its
    emissions from device memory). Without the ring every ``s_len`` up to
    ``MAX_STATES`` fits."""
    smem = viterbi_smem_bytes(s_len, vocab, warps)
    if smem <= _SMEM_LIMIT:
        return True, smem
    return False, viterbi_smem_bytes(s_len, vocab, warps, ring=False)


def _chunks(time: int) -> int:
    """Chunks of ``CHUNK`` steps of moves: steps 1 to ``T - 1``."""
    return -(-(time - 1) // CHUNK)


def pack_moves(moves: torch.Tensor) -> torch.Tensor:
    """The kernel's scratch layout of ``moves [T, B, S]`` (values 0-2):
    ``[B, chunks, words, CHUNK]`` int32, step ``t >= 1`` in chunk ``(t -
    1) // CHUNK`` at ``(t - 1) % CHUNK``; state ``s`` in bits ``[2i, 2i +
    2)`` of word ``s // k``, ``i = s % k`` (:func:`viterbi_layout`)."""
    time, batch, s_len = moves.shape
    lay = viterbi_layout(s_len)
    s = torch.arange(s_len, device=moves.device)
    bits = moves[1:].permute(1, 0, 2).long() << (2 * (s % lay.k))       # [B, T-1, S]
    words = torch.zeros(batch, _chunks(time) * CHUNK, lay.words, dtype=torch.int64,
                        device=moves.device)
    words[:, :time - 1].index_add_(2, s // lay.k, bits)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()
    return words.view(batch, -1, CHUNK, lay.words).transpose(2, 3).contiguous()


def unpack_moves(packed: torch.Tensor, input_lengths: torch.Tensor, s_len: int,
                 time: int) -> torch.Tensor:
    """The moves ``[T, B, S]`` uint8 of the plain
    :func:`voice100_tpu_torch.ops.ctc.viterbi_forward` from the kernel's
    scratch ``[B, chunks, words, CHUNK]``: 0 at ``t = 0`` and from each
    input length on, which the kernel does not write."""
    lay = viterbi_layout(s_len)
    batch = packed.shape[0]
    words = packed.transpose(2, 3).reshape(batch, -1, lay.words)[:, :time - 1]   # [B, T-1, w]
    s = torch.arange(s_len, device=packed.device)
    moves = (words[:, :, s // lay.k] >> (2 * (s % lay.k))) & 3                   # [B, T-1, S]
    moves = torch.cat([moves.new_zeros(batch, 1, s_len), moves], dim=1)
    t = torch.arange(time, device=packed.device)[:, None]
    written = (t >= 1) & (t < input_lengths.to(packed.device)[None, :])         # [T, B]
    return (moves.permute(1, 0, 2) * written[:, :, None]).to(torch.uint8)


def _lib():
    lib = load("viterbi")
    if lib.viterbi_align_f32.argtypes is None:
        lib.viterbi_align_f32.argtypes = [_P] * 10 + [_I] * 8 + [_P]
        lib.viterbi_align_f32.restype = _I
    return lib


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def viterbi_align_lattice_cuda(log_probs: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                               input_lengths: torch.Tensor, target_lengths: torch.Tensor):
    """``(score [B], path [B, T], labels [B, T], packed, alpha_last [B,
    S])`` from ``log_probs [B, T, V]`` (float32), ``z`` and ``valid [B, S]``
    of :func:`voice100_tpu_torch.ops.ctc.ctc_prep` and the lengths: the
    plain ``viterbi_forward``, ``viterbi_final`` and ``viterbi_backtrace``
    in one launch. ``path`` and ``labels`` are int32; ``packed [B, chunks,
    words, CHUNK]`` int32 is the kernel's scratch of moves
    (:func:`unpack_moves`; chunks past each input length are not
    written). ``z`` must hold ids below ``V``: the kernel gathers without
    a bounds check."""
    if log_probs.device.type == "cpu":
        moves, alpha_last = viterbi_forward(log_probs, z, valid, input_lengths)
        final_pos, score = viterbi_final(alpha_last, target_lengths)
        path, labels = viterbi_backtrace(moves, final_pos, input_lengths, z)
        return score, path, labels, pack_moves(moves), alpha_last
    batch, time, vocab = log_probs.shape
    s_len = z.shape[1]
    lay = viterbi_layout(s_len)
    ring, smem = viterbi_launch_smem(s_len, vocab, lay.warps)
    device = log_probs.device
    if device.type != "cuda":
        raise ValueError(f"viterbi_align_lattice_cuda: unsupported device {device}")
    if log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError(f"viterbi_align_lattice_cuda: expected contiguous float32 log_probs, "
                         f"got {log_probs.dtype}")
    if tuple(z.shape) != (batch, s_len) or tuple(valid.shape) != (batch, s_len):
        raise ValueError(f"viterbi_align_lattice_cuda: z and valid must be [{batch}, {s_len}]")
    lib = _lib()
    z32, valid32, in_len, tgt_len = (_int32(t, device) for t in (z, valid, input_lengths,
                                                                 target_lengths))
    score = torch.empty(batch, device=device)
    path = torch.empty(batch, time, dtype=torch.int32, device=device)
    labels = torch.empty_like(path)
    packed = torch.empty(batch, _chunks(time), lay.words, CHUNK, dtype=torch.int32,
                         device=device)
    alpha_last = torch.empty(batch, s_len, device=device)
    with torch.cuda.device(device):
        status = lib.viterbi_align_f32(
            log_probs.data_ptr(), z32.data_ptr(), valid32.data_ptr(), in_len.data_ptr(),
            tgt_len.data_ptr(), score.data_ptr(), path.data_ptr(), labels.data_ptr(),
            packed.data_ptr(), alpha_last.data_ptr(), batch, time, vocab, s_len, lay.k,
            lay.warps, int(ring), smem, torch.cuda.current_stream().cuda_stream)
    check(lib, status, "viterbi_align_f32")
    viterbi_align_lattice_cuda.launches += 1
    return score, path, labels, packed, alpha_last


viterbi_align_lattice_cuda.launches = 0


def ctc_viterbi_align_cuda(log_probs: torch.Tensor, targets: torch.Tensor,
                           input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                           blank: int = 0, max_move: int = 3) -> ViterbiResult:
    """Batched CTC forced alignment in one launch, with the arguments and
    results of :func:`voice100_tpu_torch.ops.ctc.ctc_viterbi_align`
    (``targets`` hold ids below ``V``), which it runs for tensors on the
    CPU."""
    check_viterbi_args(blank, max_move)
    if log_probs.device.type == "cpu":
        return ctc_viterbi_align(log_probs, targets, input_lengths, target_lengths)
    device = log_probs.device
    target_lengths = target_lengths.to(device)
    z, _, valid = ctc_prep(targets.to(device), target_lengths)
    score, path, labels, _, _ = viterbi_align_lattice_cuda(
        log_probs.float().contiguous(), z, valid, input_lengths, target_lengths)
    return ViterbiResult(score, path, labels)
