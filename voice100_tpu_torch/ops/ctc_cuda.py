"""CTC loss kernels: wrappers of ``csrc/ctc.cu`` and the autograd Function.

* :func:`ctc_alpha_cuda` replaces the TPU kernel
  ``voice100_tpu/ops/ctc_pallas.py::_fwd_kernel`` (via ``_ctc_fwd_call``);
* :func:`ctc_alpha_adjoint_cuda` replaces ``::_bwd_kernel`` (via
  ``_ctc_bwd_call``);
* :class:`CTCLogLikelihood` (:func:`ctc_ll`) is the per-sample
  log-likelihood ``ll[B]`` as a ``torch.autograd.Function``, the
  counterpart of ``ctc_ll_pallas`` (``ctc_pallas.py:303-391``), and
  :func:`ctc_loss_cuda` adds the reductions and ``zero_infinity`` in
  torch (``voice100_tpu/ops/ctc.py:146-154``).

The lattice always runs in float32. The forward kernel gathers the
emissions ``log_probs[b, t, z_s]`` itself; the adjoint's output
``dLL/d lp_z [T, B, S]`` is scattered to the vocabulary here with
``scatter_add_``. For tensors on the CPU the wrappers run the plain
versions of :mod:`voice100_tpu_torch.ops.ctc`; for CUDA tensors they
launch the kernels or raise, and never fall back. Each wrapper counts
its kernel launches in its ``launches`` attribute.

Limits: a block walks one sample, the forward with up to four lattice
states a thread of 1024, the adjoint with up to eight a thread of each of
its two groups of 512, so ``S = 2L + 1 <= MAX_STATES`` (4096, labels up
to 2047); and each launch's shared memory (:func:`alpha_smem_bytes`: the
lattice row and two chunks of ``log_probs`` rows; :func:`adjoint_smem_bytes`:
a ring of eight alpha rows and the ``ge`` and ``pre`` rows) must fit the
card's opt-in 227 KB a block. Both are checked before anything is loaded
or launched, and raise ``ValueError``.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import check, load
from .ctc import ctc_alpha, ctc_alpha_adjoint, ctc_prep, ll_from_alpha, reduce_loss

__all__ = ["MAX_STATES", "alpha_smem_bytes", "adjoint_smem_bytes", "ctc_alpha_cuda",
           "ctc_alpha_adjoint_cuda", "CTCLogLikelihood", "ctc_ll", "ctc_loss_cuda"]

# csrc/ctc.cu's MAX_STATES, ALPHA_RING and PAD (its ctc_max_states and
# *_smem_bytes exports give the same numbers; chip_smoke.py holds them)
MAX_STATES = 4096
_RING, _PAD = 8, 2
# the opt-in dynamic shared memory of one block on sm_90
_SMEM_LIMIT = 232448
_P, _I = ctypes.c_void_p, ctypes.c_int


def alpha_chunk(vocab: int) -> int:
    """Steps of ``log_probs`` rows a forward chunk holds: up to 4096
    floats, at most 32 steps."""
    return min(max(4096 // max(vocab, 1), 1), 32)


def alpha_smem_bytes(s_len: int, vocab: int) -> int:
    """Shared memory of a forward launch: the double-buffered row and two
    chunks of ``log_probs`` rows."""
    return (2 * (_PAD + s_len) + 2 * alpha_chunk(vocab) * vocab) * 4


def adjoint_smem_bytes(s_len: int) -> int:
    """Shared memory of an adjoint launch: the ring of alpha rows and the
    double-buffered ``ge`` and ``pre`` rows."""
    return (_RING * (_PAD + s_len) + 4 * s_len) * 4


def _lib():
    lib = load("ctc")
    if lib.ctc_alpha_f32.argtypes is None:
        lib.ctc_alpha_f32.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.ctc_alpha_f32.restype = _I
        lib.ctc_adjoint_f32.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        lib.ctc_adjoint_f32.restype = _I
        lib.ctc_alpha_smem_bytes.argtypes = [_I, _I]
        lib.ctc_alpha_smem_bytes.restype = _I
        lib.ctc_adjoint_smem_bytes.argtypes = [_I]
        lib.ctc_adjoint_smem_bytes.restype = _I
        lib.ctc_max_states.argtypes = []
        lib.ctc_max_states.restype = _I
    return lib


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check(name: str, tensors, shapes, s_len: int, smem_bytes: int):
    """Check that ``s_len`` states fit the kernel (``MAX_STATES``) and the
    launch's ``smem_bytes`` the card, validate the float tensors, then
    load the library and return it."""
    if not 1 <= s_len <= MAX_STATES or smem_bytes > _SMEM_LIMIT:
        raise ValueError(f"{name}: {s_len} lattice states do not fit the kernel (at most "
                         f"{MAX_STATES}, and {smem_bytes} bytes of shared memory of "
                         f"{_SMEM_LIMIT} with these classes)")
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: float tensors must be contiguous float32 on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return _lib()


def ctc_alpha_cuda(log_probs: torch.Tensor, z: torch.Tensor, can_skip: torch.Tensor,
                   valid: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """The forward lattice ``alpha [T, B, S]`` from ``log_probs [B, T, V]``
    (float32) and the constants of :func:`voice100_tpu_torch.ops.ctc.ctc_prep`,
    as the plain :func:`voice100_tpu_torch.ops.ctc.ctc_alpha`. ``z`` must
    hold ids below ``V``: the kernel gathers without a bounds check."""
    if log_probs.device.type == "cpu":
        return ctc_alpha(log_probs, z, can_skip, valid, input_lengths)
    batch, time, vocab = log_probs.shape
    s_len = z.shape[1]
    lib = _check("ctc_alpha_cuda", (log_probs,), ((batch, time, vocab),),
                 s_len, alpha_smem_bytes(s_len, vocab))
    device = log_probs.device
    z32, skip32, valid32 = (_int32(t, device) for t in (z, can_skip, valid))
    lens = _int32(input_lengths, device)
    alpha = torch.empty(time, batch, s_len, device=device)
    with torch.cuda.device(device):
        status = lib.ctc_alpha_f32(log_probs.data_ptr(), z32.data_ptr(), skip32.data_ptr(),
                                   valid32.data_ptr(), lens.data_ptr(), alpha.data_ptr(),
                                   batch, time, vocab, s_len,
                                   torch.cuda.current_stream().cuda_stream)
    check(lib, status, "ctc_alpha_f32")
    ctc_alpha_cuda.launches += 1
    return alpha


ctc_alpha_cuda.launches = 0


def ctc_alpha_adjoint_cuda(alpha: torch.Tensor, g_seed: torch.Tensor, can_skip: torch.Tensor,
                           valid: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """dLL/d``lp_z`` ``[T, B, S]`` from ``alpha [T, B, S]`` and the seed
    ``g_seed [B, S]`` (float32), as the plain
    :func:`voice100_tpu_torch.ops.ctc.ctc_alpha_adjoint`."""
    if alpha.device.type == "cpu":
        return ctc_alpha_adjoint(alpha, g_seed, can_skip, valid, input_lengths)
    time, batch, s_len = alpha.shape
    lib = _check("ctc_alpha_adjoint_cuda", (alpha, g_seed), ((time, batch, s_len), (batch, s_len)),
                 s_len, adjoint_smem_bytes(s_len))
    device = alpha.device
    skip32, valid32 = _int32(can_skip, device), _int32(valid, device)
    lens = _int32(input_lengths, device)
    grad = torch.empty_like(alpha)
    with torch.cuda.device(device):
        status = lib.ctc_adjoint_f32(alpha.data_ptr(), g_seed.data_ptr(), skip32.data_ptr(),
                                     valid32.data_ptr(), lens.data_ptr(), grad.data_ptr(),
                                     batch, time, s_len,
                                     torch.cuda.current_stream().cuda_stream)
    check(lib, status, "ctc_adjoint_f32")
    ctc_alpha_adjoint_cuda.launches += 1
    return grad


ctc_alpha_adjoint_cuda.launches = 0


class CTCLogLikelihood(torch.autograd.Function):
    """Per-sample CTC log-likelihood ``ll [B]`` (blank 0), differentiable
    in ``log_probs`` only.

    Forward: the lattice constants, the alpha kernel, and ``ll`` from the
    last row's two end states. Backward: the seed ``dLL/d alpha[T-1]``
    on those two states (``exp(a_end - ll)``, scaled by the incoming
    gradient), the adjoint kernel, and the scatter of ``dLL/d lp_z`` to
    the vocabulary (``ctc_pallas.py:355-388``).
    """

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths):
        device = log_probs.device
        lp = log_probs.float().contiguous()
        target_lengths = target_lengths.to(device)
        z, can_skip, valid = ctc_prep(targets.to(device), target_lengths)
        alpha = ctc_alpha_cuda(lp, z, can_skip, valid, input_lengths)
        ll, a_last, a_prev = ll_from_alpha(alpha[-1], target_lengths)
        ctx.save_for_backward(z, can_skip, valid, alpha, ll, a_last, a_prev,
                              input_lengths, target_lengths)
        ctx.vocab, ctx.dtype = log_probs.shape[2], log_probs.dtype
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        z, can_skip, valid, alpha, ll, a_last, a_prev, input_lengths, target_lengths = (
            ctx.saved_tensors)
        time, batch, s_len = alpha.shape
        end = 2 * target_lengths.long()
        w_last = torch.exp(a_last - ll)
        w_prev = torch.where(target_lengths > 0, torch.exp(a_prev - ll), 0.0)
        g_seed = torch.zeros(batch, s_len, device=alpha.device)
        g_seed.scatter_add_(1, end[:, None], w_last[:, None])
        g_seed.scatter_add_(1, (end - 1).clamp(min=0)[:, None], w_prev[:, None])
        g_seed = (g_seed * g_ll.float()[:, None]).contiguous()
        grad_e = ctc_alpha_adjoint_cuda(alpha, g_seed, can_skip, valid, input_lengths)
        grad_lp = torch.zeros(batch, time, ctx.vocab, device=alpha.device)
        grad_lp.scatter_add_(2, z[:, None, :].expand(batch, time, s_len),
                             grad_e.permute(1, 0, 2))
        return grad_lp.to(ctx.dtype), None, None, None


def ctc_ll(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
           target_lengths: torch.Tensor) -> torch.Tensor:
    """``ll [B]`` of :class:`CTCLogLikelihood`: ``log_probs [B, T, V]``,
    ``targets [B, L]``, lengths ``[B]``."""
    return CTCLogLikelihood.apply(log_probs, targets, input_lengths, target_lengths)


def ctc_loss_cuda(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
                  target_lengths: torch.Tensor, blank: int = 0, reduction: str = "mean",
                  zero_infinity: bool = True) -> torch.Tensor:
    """Batched CTC negative log-likelihood through the lattice kernels,
    with the arguments and semantics of
    :func:`voice100_tpu_torch.ops.ctc.ctc_loss`."""
    if blank != 0:
        raise ValueError("the CTC lattice takes blank 0 only")
    ll = ctc_ll(log_probs, targets, input_lengths, target_lengths)
    return reduce_loss(ll, target_lengths, reduction, zero_infinity).to(log_probs.dtype)
