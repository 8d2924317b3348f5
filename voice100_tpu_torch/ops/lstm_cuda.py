"""biLSTM kernels: wrappers of ``csrc/bilstm.cu`` and ``csrc/bilstm_train.cu``.

* :func:`bilstm_cuda`, inference, replaces the TPU kernel
  ``voice100_tpu/ops/lstm_pallas.py::_kernel`` (``_bilstm_pallas_call``
  via ``bilstm_pallas``) with its float32 semantics;
* :func:`bilstm_train_fwd_cuda` and :func:`bilstm_train_bwd_cuda`, the
  training pair, replace ``_kernel_train_fwd`` and ``_kernel_train_bwd``
  (float32 variants);
* :class:`BiLSTMFunction` (:func:`bilstm_train_cuda`) is the
  ``torch.autograd.Function`` in the shape of ``_bilstm_op``
  (``lstm_pallas.py:482-573``).

The input projection ``x @ W_ih^T + b_ih + b_hh`` stays a
``torch.matmul``, outside the kernels as in the JAX wrappers, and so do
the weight and input gradients of the backward (``dW_ih = dG^T x``,
``dW_hh = dG^T h_prev``, ``db = sum dG``, ``dx = dG W_ih``). The
inference and train-forward kernels are one persistent cooperative
launch a layer for both directions (``csrc/bilstm_persistent.cuh``); the
wrappers pass the batch rows ordered by descending length
(:func:`length_order`), so the rows valid at a step are a prefix in both
directions, and scratch for the exchange of ``h`` and the blocks' step
flags. The train backward launches twice a layer (a gate pass, then
one cooperative launch for the whole reverse recurrence). Each
cooperative grid holds ``2 H / 8`` blocks, one an SM, with ``H`` a
multiple of 32: where it cannot be resident (``H > 528`` on 132 SMs) or
its shared memory does not fit, the wrapper raises before launching
anything. See the notes at the top of the CUDA sources for what bounds
the kernels.

For tensors on the CPU each wrapper runs its plain version from
:mod:`voice100_tpu_torch.ops.lstm`. For CUDA tensors it launches the
kernel or raises; it never falls back. Each wrapper counts its kernel
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import check, load
from .lstm import bilstm, bilstm_train_bwd, bilstm_train_fwd, project_inputs

__all__ = ["bilstm_cuda", "bilstm_train_fwd_cuda", "bilstm_train_bwd_cuda",
           "BiLSTMFunction", "bilstm_train_cuda", "length_order"]

_MULTIPLE = 32  # hidden must be a multiple of this (the kernels' k chunks and tiles)
_SMEM_OPTIN_LIMIT = 232448  # the H100's shared memory a block can opt into
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = load("bilstm")
    if lib.bilstm_f32.argtypes is None:
        lib.bilstm_f32.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.bilstm_f32.restype = _I
        for fn in (lib.bilstm_smem_bytes, lib.bilstm_check):
            fn.argtypes = [_I, _I]
            fn.restype = _I
    return lib


def _train_lib():
    lib = load("bilstm_train")
    if lib.lstm_train_fwd_f32.argtypes is None:
        lib.lstm_train_fwd_f32.argtypes = [_P] * 9 + [_I] * 3 + [_P]
        lib.lstm_train_fwd_f32.restype = _I
        lib.lstm_train_bwd_gates_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.lstm_train_bwd_gates_f32.restype = _I
        lib.lstm_train_bwd_recurrence_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.lstm_train_bwd_recurrence_f32.restype = _I
        for fn in (lib.lstm_train_fwd_smem_bytes, lib.lstm_train_fwd_check,
                   lib.lstm_train_bwd_smem_bytes, lib.lstm_train_bwd_check):
            fn.argtypes = [_I, _I]
            fn.restype = _I
    return lib


def _check_cuda(name: str, tensors, shapes) -> None:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name}: every tensor must be float32 on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def bilstm_cuda(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional layer ``[B, T, D] -> [B, T, 2H]`` (float32, inference).

    ``w_ih [2, 4H, D]``, ``w_hh [2, 4H, H]`` (contiguous) and
    ``bias [2, 4H]`` hold the forward then the backward direction, as
    :func:`voice100_tpu_torch.ops.lstm.stack_directions` gives them;
    ``lengths [B]`` are the valid lengths. Same semantics as the plain
    :func:`bilstm`. One launch (``csrc/bilstm.cu``).

    Raises ``ValueError`` for ``H`` not a multiple of 32 or a batch whose
    carry does not fit one block's shared memory, and ``RuntimeError``
    when the device cannot launch the recurrence cooperatively with all
    its ``2 H / 8`` blocks resident; there is no other path.
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
    xg = project_inputs(w_ih, bias, x).contiguous()                  # [2, B, T, 4H]
    out, _ = _forward("bilstm_cuda", xg, w_hh, lengths, save_states=False)
    bilstm_cuda.launches += 1
    return out


bilstm_cuda.launches = 0


def length_order(lengths: torch.Tensor) -> torch.Tensor:
    """The batch rows ordered by descending length (int32, ties in row
    order): the order the persistent kernels walk, in which the rows valid
    at loop step ``s`` are a prefix for both directions (forward:
    ``length > s``; backward: ``length > T-1-s``)."""
    return torch.argsort(lengths, descending=True, stable=True).to(torch.int32)


def _layer_setup(name: str, xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """Checks of a layer's recurrence inputs; ``(batch, time, hidden,
    lengths as int32 on the card)``."""
    _, batch, time, gates4 = xg.shape
    hidden = gates4 // 4
    _check_cuda(name, (xg, w_hh), ((2, batch, time, gates4), (2, gates4, hidden)))
    if lengths.shape != (batch,):
        raise ValueError(f"{name}: lengths must be [{batch}], got {tuple(lengths.shape)}")
    if hidden % _MULTIPLE:
        raise ValueError(f"{name}: hidden {hidden} must be a multiple of {_MULTIPLE}")
    return batch, time, hidden, lengths.to(device=xg.device, dtype=torch.int32).contiguous()


def _check_resident(name: str, lib, prefix: str, batch: int, hidden: int) -> None:
    """Raise unless the cooperative grid of the library's ``prefix``
    entries fits one block's shared memory and can be resident."""
    if getattr(lib, f"{prefix}_smem_bytes")(batch, hidden) > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"{name}: W_hh's slice and the carry of batch {batch}, hidden "
                         f"{hidden} do not fit one block's shared memory")
    check(lib, getattr(lib, f"{prefix}_check")(batch, hidden), f"{name} (cooperative launch)")


def _forward(name: str, xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
             save_states: bool):
    """One persistent launch of the forward recurrence: kernel 1
    (``out [B, T, 2H]``, ``[]``) or, with ``save_states``, kernel 2
    (``out``, ``[h_prev, c_prev]``, each ``[2, B, T, H]``). Raises before
    launching anything when the grid cannot be resident."""
    batch, time, hidden, lengths = _layer_setup(name, xg, w_hh, lengths)
    lib, prefix = (_train_lib(), "lstm_train_fwd") if save_states else (_lib(), "bilstm")
    device = xg.device
    order = length_order(lengths)
    xchg = torch.empty(2, 2, batch, hidden, device=device)        # [ping-pong, dir, B, H]
    ready = torch.empty(2 * hidden // 8, dtype=torch.int32, device=device)  # a flag a block
    out = torch.empty(batch, time, 2 * hidden, device=device)
    states = [torch.empty(2, batch, time, hidden, device=device) for _ in range(2)] \
        if save_states else []
    with torch.cuda.device(device):
        _check_resident(name, lib, prefix, batch, hidden)
        status = getattr(lib, f"{prefix}_f32")(
            xg.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), order.data_ptr(),
            xchg.data_ptr(), ready.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in states],
            batch, time, hidden, torch.cuda.current_stream().cuda_stream)
        check(lib, status, f"{prefix}_f32")
    return out, states


def bilstm_train_fwd_cuda(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """The state-saving recurrence (kernel ``csrc/bilstm_train.cu``, one
    launch): ``xg [2, B, T, 4H]``, ``w_hh [2, 4H, H]`` -> ``out [B, T, 2H]``,
    ``h_prev, c_prev [2, B, T, H]``, as the plain
    :func:`voice100_tpu_torch.ops.lstm.bilstm_train_fwd`. Raises as
    :func:`bilstm_cuda` does."""
    if xg.device.type == "cpu":
        return bilstm_train_fwd(xg, w_hh, lengths)
    out, (h_prev, c_prev) = _forward("bilstm_train_fwd_cuda", xg, w_hh, lengths, save_states=True)
    bilstm_train_fwd_cuda.launches += 1
    return out, h_prev, c_prev


bilstm_train_fwd_cuda.launches = 0


def bilstm_train_bwd_cuda(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
                          h_prev: torch.Tensor, c_prev: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """dG ``[2, B, T, 4H]`` (kernels ``csrc/bilstm_train.cu``, two
    launches: the gate pass ``xg + h_prev W_hh^T`` over the valid rows,
    written into the dG buffer, then one cooperative launch for the whole
    reverse recurrence, which overwrites it with dG), as the plain
    :func:`voice100_tpu_torch.ops.lstm.bilstm_train_bwd`.

    Raises ``ValueError`` for shapes whose ``W_hh`` columns and carry do
    not fit one block's shared memory, and ``RuntimeError`` when the
    device cannot launch the recurrence cooperatively with all its
    ``2 H / 8`` blocks resident; there is no other path.
    """
    if xg.device.type == "cpu":
        return bilstm_train_bwd(xg, w_hh, lengths, h_prev, c_prev, dout)
    name = "bilstm_train_bwd_cuda"
    batch, time, hidden, lengths = _layer_setup(name, xg, w_hh, lengths)
    _check_cuda(name, (h_prev, c_prev, dout),
                ((2, batch, time, hidden),) * 2 + ((batch, time, 2 * hidden),))
    lib = _train_lib()
    dg = torch.empty_like(xg)
    with torch.cuda.device(xg.device):
        _check_resident(name, lib, "lstm_train_bwd", batch, hidden)
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lstm_train_bwd_gates_f32(xg.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(),
                                              h_prev.data_ptr(), dg.data_ptr(), batch, time,
                                              hidden, stream)
        check(lib, status, "lstm_train_bwd_gates_f32")
        bilstm_train_bwd_cuda.launches += 1
        status = lib.lstm_train_bwd_recurrence_f32(w_hh.data_ptr(), lengths.data_ptr(),
                                                   c_prev.data_ptr(), dout.data_ptr(),
                                                   dg.data_ptr(), batch, time, hidden, stream)
        check(lib, status, "lstm_train_bwd_recurrence_f32")
        bilstm_train_bwd_cuda.launches += 1
    return dg


bilstm_train_bwd_cuda.launches = 0


class BiLSTMFunction(torch.autograd.Function):
    """One bidirectional layer with the training kernel pair: the
    counterpart of ``_bilstm_op`` (``lstm_pallas.py:482-573``).

    Forward: ``xg`` by ``torch.matmul``, then the state-saving
    recurrence; ``xg``, the states, ``x`` and the lengths are saved.
    Backward: the dG kernels (two launches), then ``dW_ih = dG^T x``,
    ``dW_hh = dG^T h_prev``, ``d bias = sum dG`` and ``dx = dG W_ih`` as
    plain products. The bias is ``b_ih + b_hh``, so both get ``sum dG``.
    """

    @staticmethod
    def forward(ctx, w_ih, w_hh, bias, x, lengths):
        w_hh = w_hh.contiguous()
        xg = project_inputs(w_ih, bias, x).contiguous()
        out, h_prev, c_prev = bilstm_train_fwd_cuda(xg, w_hh, lengths)
        ctx.save_for_backward(w_ih, w_hh, x, lengths, xg, h_prev, c_prev)
        return out

    @staticmethod
    def backward(ctx, dout):
        w_ih, w_hh, x, lengths, xg, h_prev, c_prev = ctx.saved_tensors
        _, batch, time, gates4 = xg.shape
        dg = bilstm_train_bwd_cuda(xg, w_hh, lengths, h_prev, c_prev, dout.contiguous())
        dg2 = dg.reshape(2, batch * time, gates4)
        d_w_ih = d_w_hh = d_bias = d_x = None
        if ctx.needs_input_grad[0]:
            d_w_ih = torch.matmul(dg2.transpose(1, 2), x.reshape(1, batch * time, -1))
        if ctx.needs_input_grad[1]:
            d_w_hh = torch.matmul(dg2.transpose(1, 2), h_prev.reshape(2, batch * time, -1))
        if ctx.needs_input_grad[2]:
            d_bias = dg2.sum(dim=1)
        if ctx.needs_input_grad[3]:
            d_x = torch.matmul(dg2, w_ih).sum(dim=0).reshape(x.shape)
        return d_w_ih, d_w_hh, d_bias, d_x, None


def bilstm_train_cuda(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                      x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Differentiable bidirectional layer ``[B, T, D] -> [B, T, 2H]``,
    weights as :func:`bilstm_cuda` takes them (:class:`BiLSTMFunction`)."""
    return BiLSTMFunction.apply(w_ih, w_hh, bias, x, lengths)
