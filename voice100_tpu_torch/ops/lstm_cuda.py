"""biLSTM inference: wrapper of the CUDA recurrence kernel ``csrc/bilstm.cu``.

Replaces the TPU kernel ``voice100_tpu/ops/lstm_pallas.py::_kernel``
(``_bilstm_pallas_call`` via ``bilstm_pallas``) with its float32
semantics. The input projection ``x @ W_ih^T + b_ih + b_hh`` stays a
``torch.matmul``, outside the kernel as in the JAX wrapper; the kernel
runs one launch per time step for both directions, and this wrapper
loops over time on the current stream. It is bound on the H100 by
reading ``W_hh`` (8 MB for H=512) from L2 every step, and at T~501 by
the launches; see the note at the top of the CUDA source.

For tensors on the CPU :func:`bilstm_cuda` runs the plain version,
:func:`voice100_tpu_torch.ops.lstm.bilstm`. For CUDA tensors it launches
the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import check, load
from .lstm import bilstm

__all__ = ["bilstm_cuda"]

_UNITS = 8           # hidden units per block (csrc/bilstm.cu)
_SMEM_LIMIT = 48 * 1024


def _lib():
    lib = load("bilstm")
    if lib.bilstm_step_f32.argtypes is None:
        lib.bilstm_step_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.bilstm_step_f32.restype = ctypes.c_int
        lib.bilstm_step_smem_bytes.argtypes = [ctypes.c_int]
        lib.bilstm_step_smem_bytes.restype = ctypes.c_int
    return lib


def bilstm_cuda(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional layer ``[B, T, D] -> [B, T, 2H]`` (float32).

    ``w_ih [2, 4H, D]``, ``w_hh [2, 4H, H]`` (contiguous) and
    ``bias [2, 4H]`` hold the forward then the backward direction, as
    :func:`voice100_tpu_torch.ops.lstm.stack_directions` gives them;
    ``lengths [B]`` are the valid lengths. Same semantics as the plain
    :func:`bilstm`.
    """
    if x.device.type == "cpu":
        return bilstm(w_ih, w_hh, bias, x, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_cuda: unsupported device {x.device}")
    batch, time, d_in = x.shape
    hidden = w_hh.shape[2]
    if any(t.dtype != torch.float32 or t.device != x.device for t in (x, w_ih, w_hh, bias)):
        raise ValueError("bilstm_cuda: x and the weights must be float32 on one device")
    if (w_ih.shape != (2, 4 * hidden, d_in) or w_hh.shape != (2, 4 * hidden, hidden)
            or bias.shape != (2, 4 * hidden)):
        raise ValueError("bilstm_cuda: weight shapes do not match x")
    if not w_hh.is_contiguous():
        raise ValueError("bilstm_cuda: w_hh must be contiguous")
    if lengths.shape != (batch,):
        raise ValueError(f"bilstm_cuda: lengths must be [{batch}], got {tuple(lengths.shape)}")
    lib = _lib()
    if hidden % _UNITS or lib.bilstm_step_smem_bytes(hidden) > _SMEM_LIMIT:
        raise ValueError(f"bilstm_cuda: hidden {hidden} must be a multiple of "
                         f"{_UNITS} and fit the kernel's shared memory")

    xg = (torch.matmul(x.reshape(1, batch * time, d_in), w_ih.transpose(1, 2))
          + bias[:, None, :]).contiguous()                           # [2, B*T, 4H]
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    state = torch.zeros(2, 2, 2, batch, hidden, device=x.device)     # [ping-pong, h/c, dir]
    out = torch.empty(batch, time, 2 * hidden, device=x.device)
    ptrs = [xg.data_ptr(), w_hh.data_ptr(), lengths.data_ptr()]
    bufs = [(state[p, 0].data_ptr(), state[p, 1].data_ptr()) for p in (0, 1)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for t in range(time):
            (h_in, c_in), (h_out, c_out) = bufs[t % 2], bufs[1 - t % 2]
            status = lib.bilstm_step_f32(*ptrs, h_in, c_in, h_out, c_out, out.data_ptr(),
                                         batch, time, hidden, t, stream)
            check(lib, status, "bilstm_step_f32")
            bilstm_cuda.launches += 1
    return out


bilstm_cuda.launches = 0
