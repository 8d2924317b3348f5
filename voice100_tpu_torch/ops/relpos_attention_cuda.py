"""Kernel 9: fused relative-position attention, forward and backward, a
wrapper of ``csrc/relpos_attention.cu`` and its ``autograd.Function``.

The JAX package has no attention layer, so this kernel replaces no TPU
kernel; it serves :class:`voice100_tpu_torch.models.ConformerCTC`. It
computes :func:`voice100_tpu_torch.ops.relpos_attention.relpos_attention_plain`
(same arguments and layouts) without writing anything of size ``T x T``
but the dropout mask it reads: the forward keeps an online softmax and
saves the rows' log-sum-exp; the backward recomputes the probabilities.

* :func:`relpos_attention_fwd_cuda`: ``(out [B, T, H, D], lse [B, H, T])``,
  one launch;
* :func:`relpos_attention_bwd_cuda`: ``dq, dk, dv, dp, du, dv_bias``, two
  launches (``dK, dV`` by key tile; ``dQ`` and the positional gradient by
  query tile), then sums over the batch in torch: ``du`` and ``dv_bias``
  over rows of ``dL/d(q + u)`` and ``dL/d(q + v_b)``, ``dp`` over the
  kernel's ``G`` partial sums;
* :class:`RelPosAttention` / :func:`relpos_attention_cuda`: the
  differentiable call.

Float32 throughout, on the CUDA cores (no TF32). Sums run in another order
than the plain version's matmuls, so the two agree to float32 rounding
(the tests' tolerances say by how much). The head size is 64 (the
kernel's ``D``); other sizes raise ``ValueError`` before anything loads.
For CPU tensors the differentiable call runs the plain version; for CUDA
tensors it launches the kernel or raises. Each launch adds one to the
wrappers' ``launches`` and, while a trace records, to the program counter
``conformer.attn_launches``; a forward launch adds ``B H T^2`` to
``conformer.attn_pairs``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels.build import check, load
from ..utils.profiling import count
from .relpos_attention import relpos_attention_plain

__all__ = ["HEAD_DIM", "relpos_attention_fwd_cuda", "relpos_attention_bwd_cuda",
           "RelPosAttention", "relpos_attention_cuda"]

HEAD_DIM = 64     # csrc/relpos_attention.cu's D
MAX_GROUPS = 8    # partial sums of the positional gradient: rows b % G
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = load("relpos_attention")
    if lib.relpos_attn_fwd_f32.argtypes is None:
        lib.relpos_attn_fwd_f32.argtypes = [_P] * 10 + [_I] * 3 + [_F, _P]
        lib.relpos_attn_fwd_f32.restype = _I
        lib.relpos_attn_bwd_f32.argtypes = [_P] * 16 + [_I] * 4 + [_F, _P]
        lib.relpos_attn_bwd_f32.restype = _I
    return lib


def _check(name, q, k, v, p, u, vb, keep):
    batch, time, heads, dim = q.shape
    if dim != HEAD_DIM:
        raise ValueError(f"{name}: head size {dim}; the kernel takes {HEAD_DIM}")
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    shapes = {"q": (q, q.shape), "k": (k, q.shape), "v": (v, q.shape),
              "p": (p, (2 * time - 1, heads, dim)), "pos_bias_u": (u, (heads, dim)),
              "pos_bias_v": (vb, (heads, dim))}
    for label, (t, shape) in shapes.items():
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous float32 on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if keep is not None and (keep.dtype != torch.uint8 or keep.device != device
                             or not keep.is_contiguous()
                             or tuple(keep.shape) != (batch, heads, time, time)):
        raise ValueError(f"{name}: keep must be a contiguous uint8 [B, H, T, T] on {device}")
    return _lib()


def _keep_args(keep: Optional[torch.Tensor], dropout_p: float):
    if keep is None:
        return None, 1.0
    return keep.data_ptr(), 1.0 / (1.0 - dropout_p)


def _count(n: int, pairs: int = 0) -> None:
    count("conformer.attn_launches", n)
    if pairs:
        count("conformer.attn_pairs", pairs)


def relpos_attention_fwd_cuda(q, k, v, p, pos_bias_u, pos_bias_v, lengths,
                              keep: Optional[torch.Tensor] = None, dropout_p: float = 0.0):
    """``(out [B, T, H, D], lse [B, H, T])`` of one forward launch."""
    lib = _check("relpos_attention_fwd_cuda", q, k, v, p, pos_bias_u, pos_bias_v, keep)
    batch, time, heads, _ = q.shape
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(batch, heads, time, device=q.device)
    keep_ptr, keep_scale = _keep_args(keep, dropout_p)
    with torch.cuda.device(q.device):
        status = lib.relpos_attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), pos_bias_u.data_ptr(),
            pos_bias_v.data_ptr(), lens.data_ptr(), keep_ptr, out.data_ptr(), lse.data_ptr(),
            batch, time, heads, keep_scale, torch.cuda.current_stream().cuda_stream)
    check(lib, status, "relpos_attn_fwd_f32")
    relpos_attention_fwd_cuda.launches += 1
    _count(1, batch * heads * time * time)
    return out, lse


relpos_attention_fwd_cuda.launches = 0


def relpos_attention_bwd_cuda(dout, q, k, v, p, pos_bias_u, pos_bias_v, lengths, out, lse,
                              keep: Optional[torch.Tensor] = None, dropout_p: float = 0.0):
    """``(dq, dk, dv, dp, du, dv_bias)`` of the forward's ``out`` and ``lse``."""
    lib = _check("relpos_attention_bwd_cuda", q, k, v, p, pos_bias_u, pos_bias_v, keep)
    batch, time, heads, dim = q.shape
    dout = dout.float().contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    # Delta_i = dO_i . o_i, [B, H, T] as the kernels read it
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    groups = min(batch, MAX_GROUPS)
    dq_u, dq_v = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dp_part = torch.zeros(groups, 2 * time - 1, heads, dim, device=q.device)
    keep_ptr, keep_scale = _keep_args(keep, dropout_p)
    with torch.cuda.device(q.device):
        status = lib.relpos_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), pos_bias_u.data_ptr(),
            pos_bias_v.data_ptr(), lens.data_ptr(), keep_ptr, dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq_u.data_ptr(), dq_v.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dp_part.data_ptr(), batch, time, heads, groups, keep_scale,
            torch.cuda.current_stream().cuda_stream)
    check(lib, status, "relpos_attn_bwd_f32")
    relpos_attention_bwd_cuda.launches += 2
    _count(2)
    return (dq_u + dq_v, dk, dv, dp_part.sum(0), dq_u.sum((0, 1)), dq_v.sum((0, 1)))


relpos_attention_bwd_cuda.launches = 0


class RelPosAttention(torch.autograd.Function):
    """Kernel 9 as a differentiable function of ``q, k, v, p`` and both
    biases (lengths and the keep mask take no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, p, pos_bias_u, pos_bias_v, lengths, keep, dropout_p):
        out, lse = relpos_attention_fwd_cuda(q, k, v, p, pos_bias_u, pos_bias_v, lengths, keep,
                                             dropout_p)
        ctx.save_for_backward(q, k, v, p, pos_bias_u, pos_bias_v, lengths, keep, out, lse)
        ctx.dropout_p = dropout_p
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, p, u, vb, lengths, keep, out, lse = ctx.saved_tensors
        grads = relpos_attention_bwd_cuda(dout, q, k, v, p, u, vb, lengths, out, lse, keep,
                                          ctx.dropout_p)
        return (*grads, None, None, None)


def relpos_attention_cuda(q, k, v, p, pos_bias_u, pos_bias_v, lengths,
                          keep: Optional[torch.Tensor] = None, dropout_p: float = 0.0):
    """``[B, T, H, D]`` relative-position attention through kernel 9 (the
    plain version for CPU tensors). Inputs are made contiguous first."""
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, p, pos_bias_u, pos_bias_v, lengths, keep,
                                      dropout_p)
    c = [t.contiguous() for t in (q, k, v, p, pos_bias_u, pos_bias_v)]
    return RelPosAttention.apply(*c, lengths, keep, float(dropout_p))
