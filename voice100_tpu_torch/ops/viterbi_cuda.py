"""CTC Viterbi forced alignment: wrappers of ``csrc/viterbi.cu``.

* :func:`viterbi_forward_cuda` replaces the TPU kernel
  ``voice100_tpu/ops/ctc_pallas.py::_vit_fwd_kernel``;
* :func:`viterbi_backtrace_cuda` replaces ``::_vit_bt_kernel``;
* :func:`ctc_viterbi_align_cuda` is the whole alignment, the counterpart
  of ``ctc_viterbi_pallas`` (``ctc_pallas.py:464-565``): the lattice
  constants, the forward kernel, the choice of the final state in torch
  (:func:`voice100_tpu_torch.ops.ctc.viterbi_final`), and the backtrace
  kernel.

The lattice runs in float32. The forward kernel gathers the emissions
``log_probs[b, t, z_s]`` itself and writes the moves (uint8 ``[T, B, S]``)
and only the last lattice row. For tensors on the CPU the wrappers run the
plain versions of :mod:`voice100_tpu_torch.ops.ctc`; for CUDA tensors they
launch the kernels or raise, and never fall back. Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import check, load
from .ctc import (
    ViterbiResult, check_viterbi_args, ctc_prep, viterbi_backtrace, viterbi_final, viterbi_forward,
)

__all__ = ["viterbi_forward_cuda", "viterbi_backtrace_cuda", "ctc_viterbi_align_cuda"]

_SMEM_LIMIT = 48 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = load("viterbi")
    if lib.viterbi_fwd_f32.argtypes is None:
        lib.viterbi_fwd_f32.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.viterbi_fwd_f32.restype = _I
        lib.viterbi_backtrace_i32.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        lib.viterbi_backtrace_i32.restype = _I
        lib.viterbi_fwd_smem_bytes.argtypes = [_I, _I]
        lib.viterbi_fwd_smem_bytes.restype = _I
    return lib


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def viterbi_forward_cuda(log_probs: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                         input_lengths: torch.Tensor):
    """``(moves [T, B, S] uint8, alpha_last [B, S])`` from ``log_probs
    [B, T, V]`` (float32), ``z`` and ``valid [B, S]`` of
    :func:`voice100_tpu_torch.ops.ctc.ctc_prep` and the input lengths, as
    the plain :func:`voice100_tpu_torch.ops.ctc.viterbi_forward`. ``z``
    must hold ids below ``V``: the kernel gathers without a bounds check."""
    if log_probs.device.type == "cpu":
        return viterbi_forward(log_probs, z, valid, input_lengths)
    _check("viterbi_forward_cuda", log_probs, torch.float32, log_probs.shape)
    batch, time, vocab = log_probs.shape
    s_len = z.shape[1]
    lib = _lib()
    if lib.viterbi_fwd_smem_bytes(s_len, vocab) > _SMEM_LIMIT:
        raise ValueError(f"viterbi_forward_cuda: {s_len} lattice states and {vocab} classes do "
                         f"not fit the kernel's shared memory")
    device = log_probs.device
    z32, valid32, lens = (_int32(t, device) for t in (z, valid, input_lengths))
    moves = torch.empty(time, batch, s_len, dtype=torch.uint8, device=device)
    alpha_last = torch.empty(batch, s_len, device=device)
    with torch.cuda.device(device):
        status = lib.viterbi_fwd_f32(log_probs.data_ptr(), z32.data_ptr(), valid32.data_ptr(),
                                     lens.data_ptr(), moves.data_ptr(), alpha_last.data_ptr(),
                                     batch, time, vocab, s_len,
                                     torch.cuda.current_stream().cuda_stream)
    check(lib, status, "viterbi_fwd_f32")
    viterbi_forward_cuda.launches += 1
    return moves, alpha_last


viterbi_forward_cuda.launches = 0


def viterbi_backtrace_cuda(moves: torch.Tensor, final_pos: torch.Tensor,
                           input_lengths: torch.Tensor, z: torch.Tensor):
    """``(path, labels)``, ``[B, T]`` int32, from ``moves [T, B, S]``
    (uint8), the final states ``[B]``, the input lengths and ``z [B, S]``,
    as the plain :func:`voice100_tpu_torch.ops.ctc.viterbi_backtrace`."""
    if moves.device.type == "cpu":
        return viterbi_backtrace(moves, final_pos, input_lengths, z)
    _check("viterbi_backtrace_cuda", moves, torch.uint8, moves.shape)
    time, batch, s_len = moves.shape
    lib = _lib()
    device = moves.device
    final32, lens, z32 = (_int32(t, device) for t in (final_pos, input_lengths, z))
    path = torch.empty(batch, time, dtype=torch.int32, device=device)
    labels = torch.empty_like(path)
    with torch.cuda.device(device):
        status = lib.viterbi_backtrace_i32(moves.data_ptr(), final32.data_ptr(), lens.data_ptr(),
                                           z32.data_ptr(), path.data_ptr(), labels.data_ptr(),
                                           batch, time, s_len,
                                           torch.cuda.current_stream().cuda_stream)
    check(lib, status, "viterbi_backtrace_i32")
    viterbi_backtrace_cuda.launches += 1
    return path, labels


viterbi_backtrace_cuda.launches = 0


def ctc_viterbi_align_cuda(log_probs: torch.Tensor, targets: torch.Tensor,
                           input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                           blank: int = 0, max_move: int = 3) -> ViterbiResult:
    """Batched CTC forced alignment through the two kernels, with the
    arguments and results of :func:`voice100_tpu_torch.ops.ctc.ctc_viterbi_align`
    (``targets`` hold ids below ``V``)."""
    check_viterbi_args(blank, max_move)
    device = log_probs.device
    target_lengths = target_lengths.to(device)
    input_lengths = input_lengths.to(device)
    z, _, valid = ctc_prep(targets.to(device), target_lengths)
    moves, alpha_last = viterbi_forward_cuda(log_probs.float().contiguous(), z, valid,
                                             input_lengths)
    final_pos, score = viterbi_final(alpha_last, target_lengths)
    path, labels = viterbi_backtrace_cuda(moves, final_pos, input_lengths, z)
    return ViterbiResult(score, path, labels)
