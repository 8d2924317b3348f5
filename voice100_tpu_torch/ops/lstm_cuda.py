"""biLSTM kernels: wrappers of ``csrc/bilstm.cu`` and ``csrc/bilstm_train.cu``.

* :func:`bilstm_cuda`, inference, replaces the TPU kernel
  ``voice100_tpu/ops/lstm_pallas.py::_kernel`` (``_bilstm_pallas_call``
  via ``bilstm_pallas``);
* :func:`bilstm_train_fwd_cuda` and :func:`bilstm_train_bwd_cuda`, the
  training pair, replace ``_kernel_train_fwd`` and ``_kernel_train_bwd``;
* :class:`BiLSTMFunction` (:func:`bilstm_train_cuda`) is the
  ``torch.autograd.Function`` in the shape of ``_bilstm_op``
  (``lstm_pallas.py:482-573``);
* :func:`bilstm_infer` registers :func:`bilstm_cuda` as the custom op
  ``voice100_torch::bilstm_infer``: its CUDA implementation launches
  kernel 1, its CPU implementation is the plain twin, a fake
  implementation gives ``torch.export`` the output's shape, and the
  compute dtype is an argument, so an exported program holds one op a
  layer with its dtype fixed.

Each kernel has a float32 variant and a bf16 one, the mixed-precision
mode of ``ops/lstm.py`` (the ``*_bf16`` entries of the CUDA sources):
``compute_dtype=torch.bfloat16`` for :func:`bilstm_cuda` and
:func:`bilstm_train_cuda`, a bf16 ``xg`` for the training pair, which
then takes bf16 states and ``dout`` and nothing else. Each wrapper counts
the launches of its float32 variant in ``launches`` and of its bf16
variant in ``launches_bf16``.

The input projection ``x @ W_ih^T + b_ih + b_hh`` stays a
``torch.matmul``, outside the kernels as in the JAX wrappers, and so do
the weight and input gradients of the backward (``dW_ih = dG^T x``,
``dW_hh = dG^T h_prev``, ``db = sum dG``, ``dx = dG W_ih``). The
inference and train-forward kernels are one persistent cooperative
launch a layer for both directions: in float32 the kernel of
``csrc/bilstm_persistent.cuh``, in bf16 that of ``csrc/bilstm_fwd_mma.cuh``,
whose ``h W_hh^T`` runs on the tensor cores as a three-term bf16 split
held to float32 (:func:`fwd_mma_plan` gives its launch). The wrappers
pass the batch rows ordered by descending length (:func:`length_order`),
so the rows valid at a step are a prefix in both directions, and scratch
for the exchange of ``h`` and the blocks' step flags. The train backward
launches twice a layer (a gate pass, then
one cooperative launch for the whole reverse recurrence); its bf16
recurrence is the kernel of ``csrc/bilstm_bwd_cluster.cuh``, clusters of
blocks that share each step's float32 dG (:func:`bwd_cluster_plan`
gives its launch), which also takes the rows in length order. Each
cooperative grid holds ``2 H / 8`` blocks, one an SM, with ``H`` a
multiple of 32: where it cannot be resident (``H > 528`` on 132 SMs) or
its shared memory does not fit, the wrapper raises before launching
anything. See the notes at the top of the CUDA sources for what bounds
the kernels.

For tensors on the CPU each wrapper runs its plain version from
:mod:`voice100_tpu_torch.ops.lstm`. For CUDA tensors it launches the
kernel or raises; it never falls back: a tensor of another dtype than
the variant takes raises ``ValueError`` before anything is launched.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..kernels.build import check, load
from .lstm import bilstm, bilstm_train_bwd, bilstm_train_fwd, matmul_f32, project_inputs

__all__ = ["bilstm_cuda", "bilstm_infer", "bilstm_train_fwd_cuda", "bilstm_train_bwd_cuda",
           "BiLSTMFunction", "bilstm_train_cuda", "length_order", "bwd_cluster_plan",
           "bwd_cluster_batch_cap", "fwd_mma_plan", "fwd_mma_batch_cap"]

_MULTIPLE = 32  # hidden must be a multiple of this (the kernels' k chunks and tiles)
_SMEM_OPTIN_LIMIT = 232448  # the H100's shared memory a block can opt into
_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib, pointers: int, names) -> None:
    """ctypes signatures: ``pointers`` pointers, batch, time, hidden and
    the stream."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [_P] * pointers + [_I] * 3 + [_P]
        fn.restype = _I


def _declare_sizes(lib, names) -> None:
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [_I, _I]
        fn.restype = _I


def _lib():
    lib = load("bilstm")
    if lib.bilstm_f32.argtypes is None:
        _declare(lib, 7, ("bilstm_f32", "bilstm_bf16"))
        _declare_sizes(lib, ("bilstm_smem_bytes", "bilstm_check", "bilstm_smem_bytes_bf16",
                             "bilstm_check_bf16"))
    return lib


def _train_lib():
    lib = load("bilstm_train")
    if lib.lstm_train_fwd_f32.argtypes is None:
        _declare(lib, 9, ("lstm_train_fwd_f32", "lstm_train_fwd_bf16"))
        _declare(lib, 5, ("lstm_train_bwd_gates_f32", "lstm_train_bwd_gates_bf16",
                          "lstm_train_bwd_recurrence_f32"))
        _declare(lib, 9, ("lstm_train_bwd_recurrence_bf16",))
        _declare_sizes(lib, ("lstm_train_fwd_smem_bytes", "lstm_train_fwd_check",
                             "lstm_train_fwd_smem_bytes_bf16", "lstm_train_fwd_check_bf16",
                             "lstm_train_bwd_smem_bytes",
                             "lstm_train_bwd_check", "lstm_train_bwd_cluster_smem_bytes",
                             "lstm_train_bwd_cluster_check_bf16"))
        lib.lstm_train_bwd_cluster_size.argtypes = [_I]
        lib.lstm_train_bwd_cluster_size.restype = _I
    return lib


# The launch of kernel 3b's recurrence (csrc/bilstm_bwd_cluster.cuh): its
# constants, for the shared memory a block.
_UNITS = 8           # hidden units a block
_BWD_WARPS = 8       # warps a block, each with a ring of chunk slots
_BWD_SLOTS = 4       # slots a warp, each a chunk of 32 rows
_BWD_PASS = 64       # rows a pass of the dh product
_BWD_Q = 32          # gate rows a chunk
_BWD_BARRIERS = 2 * _BWD_SLOTS * _BWD_WARPS  # mbarriers, 8 bytes each


def _bwd_cluster_smem(batch: int, hidden: int) -> int:
    return ((_BWD_WARPS * _BWD_SLOTS * _BWD_PASS // 2 * _BWD_Q + 4 * hidden * _UNITS
             + _BWD_WARPS * _BWD_PASS // 2 * _UNITS) * 4 + _BWD_BARRIERS * 8
            + batch * (2 * _UNITS * 4 + 2 * 4))


def bwd_cluster_batch_cap(hidden: int) -> int:
    """The largest batch whose kernel 3b recurrence fits one block's
    shared memory at ``hidden``."""
    return (_SMEM_OPTIN_LIMIT - _bwd_cluster_smem(0, hidden)) // (2 * _UNITS * 4 + 2 * 4)


def bwd_cluster_plan(batch: int, hidden: int) -> dict:
    """The launch of kernel 3b's recurrence for a layer, as
    ``csrc/bilstm_bwd_cluster.cuh`` makes it: ``cluster`` blocks a cluster
    (up to 120 blocks, 8 where a direction's ``H / 8`` blocks split into
    clusters of 8, else 4; past 120, 2: the H100 holds 15 clusters of 8,
    30 of 4 and 66 of 2 resident), ``blocks`` (``2 H / 8``, a direction's
    in whole clusters), ``clusters`` and ``smem_bytes`` a block. Raises
    ``ValueError`` for
    ``H`` not a multiple of 32, an empty batch, or a block whose shared
    memory passes the opt-in (``B > bwd_cluster_batch_cap(H)``)."""
    if hidden <= 0 or hidden % _MULTIPLE:
        raise ValueError(f"kernel 3b: hidden {hidden} must be a multiple of {_MULTIPLE}")
    if batch <= 0:
        raise ValueError(f"kernel 3b: batch {batch} must be positive")
    smem = _bwd_cluster_smem(batch, hidden)
    if smem > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"kernel 3b: the slots, W_hh's columns and the carry of batch {batch}, "
                         f"hidden {hidden} take {smem} B of shared memory, past the "
                         f"{_SMEM_OPTIN_LIMIT} B a block can have (batch <= "
                         f"{bwd_cluster_batch_cap(hidden)})")
    per_direction = hidden // _UNITS
    cluster = (8 if per_direction % 8 == 0 else 4) if per_direction <= 60 else 2
    blocks = 2 * per_direction
    return {"cluster": cluster, "blocks": blocks, "clusters": blocks // cluster,
            "smem_bytes": smem}


# The launch of kernels 1b and 2b (csrc/bilstm_fwd_mma.cuh): its constants,
# for the shared memory a block and the exchange's rows.
_MMA_TILE = 16          # batch rows an m tile, columns of h a k tile
_MMA_WARPS = 8          # warps a block, each with 16 float4 of partial sums a lane
_MMA_FRAG_BYTES = 4 * 32 * 16  # W_hh's hi and lo B fragments a k tile
_MMA_ROW_BYTES = 2 * _UNITS * 4 + 2 * 4  # a row's (c, h) carry, length and position


def _fwd_mma_smem(batch: int, hidden: int) -> int:
    return (hidden // _MMA_TILE * _MMA_FRAG_BYTES + _MMA_WARPS * 4 * 32 * 16
            + batch * _MMA_ROW_BYTES)


def fwd_mma_batch_cap(hidden: int) -> int:
    """The largest batch whose kernel 1b / 2b launch fits one block's
    shared memory at ``hidden``."""
    return (_SMEM_OPTIN_LIMIT - _fwd_mma_smem(0, hidden)) // _MMA_ROW_BYTES


def fwd_mma_plan(batch: int, hidden: int) -> dict:
    """The launch of kernels 1b and 2b, the bf16 forward recurrences, for
    a layer, as ``csrc/bilstm_fwd_mma.cuh`` makes it: ``blocks``
    (``2 H / 8``, one an SM), ``smem_bytes`` a block (W_hh's split slice
    in fragment order, the warps' partial sums, the carry) and
    ``exchange_rows``, the batch rounded up to whole m tiles of 16: the
    exchange of ``h`` holds ``[2, 2, exchange_rows, H]`` floats' bytes.
    Raises ``ValueError`` for ``H`` not a multiple of 32, an empty batch,
    or a block whose shared memory passes the opt-in
    (``B > fwd_mma_batch_cap(H)``)."""
    if hidden <= 0 or hidden % _MULTIPLE:
        raise ValueError(f"kernels 1b/2b: hidden {hidden} must be a multiple of {_MULTIPLE}")
    if batch <= 0:
        raise ValueError(f"kernels 1b/2b: batch {batch} must be positive")
    smem = _fwd_mma_smem(batch, hidden)
    if smem > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"kernels 1b/2b: W_hh's fragments, the sums and the carry of batch "
                         f"{batch}, hidden {hidden} take {smem} B of shared memory, past the "
                         f"{_SMEM_OPTIN_LIMIT} B a block can have (batch <= "
                         f"{fwd_mma_batch_cap(hidden)})")
    return {"blocks": 2 * hidden // _UNITS, "smem_bytes": smem,
            "exchange_rows": -(-batch // _MMA_TILE) * _MMA_TILE}


def _variant(name: str, xg: torch.Tensor) -> str:
    """``"f32"`` or ``"bf16"``, the variant the dtype of ``xg`` selects."""
    if xg.dtype == torch.float32:
        return "f32"
    if xg.dtype == torch.bfloat16:
        return "bf16"
    raise ValueError(f"{name}: xg must be float32 or bfloat16, got {xg.dtype}")


def _check_cuda(name: str, tensors, shapes, dtypes) -> None:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t, shape, dtype in zip(tensors, shapes, dtypes):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def bilstm_cuda(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                x: torch.Tensor, lengths: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bidirectional layer ``[B, T, D] -> [B, T, 2H]`` (inference).

    ``w_ih [2, 4H, D]``, ``w_hh [2, 4H, H]`` (contiguous) and
    ``bias [2, 4H]`` hold the forward then the backward direction, as
    :func:`voice100_tpu_torch.ops.lstm.stack_directions` gives them;
    ``lengths [B]`` are the valid lengths; all float32. Same semantics as
    the plain :func:`bilstm`. One launch (``csrc/bilstm.cu``): the float32
    variant, or with ``compute_dtype=torch.bfloat16`` the bf16 one (kernel
    1b, ``csrc/bilstm_fwd_mma.cuh``) on the float32 projection rounded to
    bf16.

    Raises ``ValueError`` for ``H`` not a multiple of 32 or a batch whose
    carry does not fit one block's shared memory (in bf16 past
    :func:`fwd_mma_batch_cap`, before the projection), and ``RuntimeError``
    when the device cannot launch the recurrence cooperatively with all
    its ``2 H / 8`` blocks resident; there is no other path.
    """
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"bilstm_cuda: compute dtype {compute_dtype}: only bfloat16 or None")
    if x.device.type == "cpu":
        return bilstm(w_ih, w_hh, bias, x, lengths, compute_dtype)
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
    if compute_dtype == torch.bfloat16:
        fwd_mma_plan(batch, hidden)  # raises before anything is launched
    xg = project_inputs(w_ih, bias, x).to(compute_dtype or torch.float32).contiguous()
    out, _ = _forward("bilstm_cuda", xg, w_hh, lengths, save_states=False)
    _count(bilstm_cuda, xg)
    return out


@torch.library.custom_op("voice100_torch::bilstm_infer", mutates_args=())
def bilstm_infer(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                 lengths: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`bilstm_cuda` as one op (``voice100_torch::bilstm_infer``): on
    CUDA tensors kernel 1 (float32, or its bf16 variant with
    ``compute_dtype=torch.bfloat16``), counted in ``bilstm_cuda``'s
    counters; on CPU tensors the plain twin. The biLSTM's inference path
    calls it, so ``torch.export`` traces one node a layer through it."""
    return bilstm_cuda(w_ih, w_hh, bias, x, lengths, compute_dtype)


@bilstm_infer.register_fake
def _bilstm_infer_fake(w_ih, w_hh, bias, x, lengths, compute_dtype=None):
    return x.new_empty(x.shape[0], x.shape[1], 2 * w_hh.shape[2], dtype=torch.float32)


_COUNT_LOCK = threading.Lock()  # serving launches from more than one thread
# A residency check sets the kernel's shared-memory limit for its shape
# (cudaFuncSetAttribute, one value a kernel function for the process) and
# the launch relies on it: the two must not interleave with another
# thread's check at another shape (the server's ASR and TTS batchers
# launch kernel 1 at H=512 and H=256), or the launch is refused.
_LAUNCH_LOCK = threading.Lock()


def _count(wrapper, xg: torch.Tensor) -> None:
    """One launch of ``wrapper``'s variant for ``xg``."""
    with _COUNT_LOCK:
        if xg.dtype == torch.bfloat16:
            wrapper.launches_bf16 += 1
        else:
            wrapper.launches += 1


bilstm_cuda.launches = bilstm_cuda.launches_bf16 = 0


def length_order(lengths: torch.Tensor) -> torch.Tensor:
    """The batch rows ordered by descending length (int32, ties in row
    order): the order the persistent kernels walk, in which the rows valid
    at loop step ``s`` are a prefix for both directions (forward:
    ``length > s``; backward: ``length > T-1-s``)."""
    return torch.argsort(lengths, descending=True, stable=True).to(torch.int32)


def _layer_setup(name: str, xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """Checks of a layer's recurrence inputs (``xg`` float32 or bf16,
    ``w_hh`` float32); ``(batch, time, hidden, lengths as int32 on the
    card)``."""
    _, batch, time, gates4 = xg.shape
    hidden = gates4 // 4
    _variant(name, xg)
    _check_cuda(name, (xg, w_hh), ((2, batch, time, gates4), (2, gates4, hidden)),
                (xg.dtype, torch.float32))
    if lengths.shape != (batch,):
        raise ValueError(f"{name}: lengths must be [{batch}], got {tuple(lengths.shape)}")
    if hidden % _MULTIPLE:
        raise ValueError(f"{name}: hidden {hidden} must be a multiple of {_MULTIPLE}")
    return batch, time, hidden, lengths.to(device=xg.device, dtype=torch.int32).contiguous()


def _check_resident(name: str, lib, prefix: str, variant: str, batch: int, hidden: int) -> None:
    """Raise unless the cooperative grid of the library's ``prefix``
    entries (``variant`` ``"f32"`` or ``"bf16"``) fits one block's shared
    memory and can be resident."""
    if getattr(lib, f"{prefix}_smem_bytes")(batch, hidden) > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"{name}: W_hh's slice and the carry of batch {batch}, hidden "
                         f"{hidden} do not fit one block's shared memory")
    suffix = "_bf16" if variant == "bf16" else ""
    check(lib, getattr(lib, f"{prefix}_check{suffix}")(batch, hidden),
          f"{name} (cooperative launch)")


def _forward(name: str, xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
             save_states: bool):
    """One persistent launch of the forward recurrence: kernel 1
    (``out [B, T, 2H]``, ``[]``) or, with ``save_states``, kernel 2
    (``out``, ``[h_prev, c_prev]``, each ``[2, B, T, H]`` in the dtype of
    ``xg``). The bf16 variant (kernels 1b, 2b) is planned by
    :func:`fwd_mma_plan`, which raises past its batch cap before anything
    is loaded. Raises before launching anything when the grid cannot be
    resident."""
    batch, time, hidden, lengths = _layer_setup(name, xg, w_hh, lengths)
    variant = _variant(name, xg)
    rows = fwd_mma_plan(batch, hidden)["exchange_rows"] if variant == "bf16" else batch
    lib, prefix = (_train_lib(), "lstm_train_fwd") if save_states else (_lib(), "bilstm")
    device = xg.device
    order = length_order(lengths)
    # [ping-pong, dir, rows, H] floats' bytes: float32 h by sorted row, or in
    # bf16 h split into hi and lo halves, in the mma's A-fragment order
    xchg = torch.empty(2, 2, rows, hidden, device=device)
    ready = torch.empty(2 * hidden // _UNITS, dtype=torch.int32, device=device)  # a flag a block
    out = torch.empty(batch, time, 2 * hidden, device=device)
    states = [torch.empty(2, batch, time, hidden, device=device, dtype=xg.dtype)
              for _ in range(2)] if save_states else []
    with torch.cuda.device(device), _LAUNCH_LOCK:
        if variant == "bf16":  # the plan has checked its shared memory
            check(lib, getattr(lib, f"{prefix}_check_bf16")(batch, hidden),
                  f"{name} (cooperative launch)")
        else:
            _check_resident(name, lib, prefix, variant, batch, hidden)
        status = getattr(lib, f"{prefix}_{variant}")(
            xg.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), order.data_ptr(),
            xchg.data_ptr(), ready.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in states],
            batch, time, hidden, torch.cuda.current_stream().cuda_stream)
        check(lib, status, f"{prefix}_{variant}")
    return out, states


def bilstm_train_fwd_cuda(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """The state-saving recurrence (kernel ``csrc/bilstm_train.cu``, one
    launch): ``xg [2, B, T, 4H]``, ``w_hh [2, 4H, H]`` -> ``out [B, T, 2H]``,
    ``h_prev, c_prev [2, B, T, H]``, as the plain
    :func:`voice100_tpu_torch.ops.lstm.bilstm_train_fwd`. A bf16 ``xg``
    launches the bf16 variant (kernel 2b, ``csrc/bilstm_fwd_mma.cuh``),
    whose states are bf16; ``out`` is float32 either way. Raises as
    :func:`bilstm_cuda` does."""
    if xg.device.type == "cpu":
        return bilstm_train_fwd(xg, w_hh, lengths)
    out, (h_prev, c_prev) = _forward("bilstm_train_fwd_cuda", xg, w_hh, lengths, save_states=True)
    _count(bilstm_train_fwd_cuda, xg)
    return out, h_prev, c_prev


bilstm_train_fwd_cuda.launches = bilstm_train_fwd_cuda.launches_bf16 = 0


def bilstm_train_bwd_cuda(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
                          h_prev: torch.Tensor, c_prev: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """dG ``[2, B, T, 4H]`` (kernels ``csrc/bilstm_train.cu``, two
    launches: the gate pass ``xg + h_prev W_hh^T`` over the valid rows,
    then one cooperative launch for the whole reverse recurrence), as the
    plain :func:`voice100_tpu_torch.ops.lstm.bilstm_train_bwd`.

    The float32 variant writes the gates into the dG buffer, which the
    recurrence overwrites with dG. A bf16 ``xg`` launches the bf16
    variant, which takes bf16 ``h_prev``, ``c_prev`` and ``dout`` and
    returns dG in bf16; its gates go to a float32 buffer of their own and
    its recurrence (``csrc/bilstm_bwd_cluster.cuh``, launched as
    :func:`bwd_cluster_plan` says) takes the rows in length order and
    exchanges the float32 dG through a second one, so nothing that forms
    the next step is rounded.

    Raises ``ValueError`` for another dtype than the variant's, or for
    shapes whose ``W_hh`` columns and carry do not fit one block's shared
    memory (before loading or launching anything), and ``RuntimeError``
    when the device cannot launch the recurrence cooperatively with all
    its ``2 H / 8`` blocks resident; there is no other path.
    """
    if xg.device.type == "cpu":
        return bilstm_train_bwd(xg, w_hh, lengths, h_prev, c_prev, dout)
    name = "bilstm_train_bwd_cuda"
    batch, time, hidden, lengths = _layer_setup(name, xg, w_hh, lengths)
    variant = _variant(name, xg)
    _check_cuda(name, (h_prev, c_prev, dout),
                ((2, batch, time, hidden),) * 2 + ((batch, time, 2 * hidden),), (xg.dtype,) * 3)
    bf16 = variant == "bf16"
    if bf16:
        bwd_cluster_plan(batch, hidden)  # raises before anything is loaded or launched
    lib = _train_lib()
    dg = torch.empty_like(xg)
    if bf16:  # the float32 gates; the rows in length order, the float32 dG exchange
        # [ping-pong, dir, 4H / 32, B, 32] and a flag a block
        gates = torch.empty(xg.shape, device=xg.device)
        pointers = [lengths, length_order(lengths), c_prev, dout, gates,
                    torch.empty(2, 2, batch, 4 * hidden, device=xg.device),
                    torch.empty(2 * hidden // _UNITS, dtype=torch.int32, device=xg.device), dg]
    else:
        gates = dg
        pointers = [lengths, c_prev, dout, dg]
    with torch.cuda.device(xg.device), _LAUNCH_LOCK:
        _check_resident(name, lib, "lstm_train_bwd_cluster" if bf16 else "lstm_train_bwd",
                        variant, batch, hidden)
        stream = torch.cuda.current_stream().cuda_stream
        entry = f"lstm_train_bwd_gates_{variant}"
        status = getattr(lib, entry)(xg.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(),
                                     h_prev.data_ptr(), gates.data_ptr(), batch, time, hidden,
                                     stream)
        check(lib, status, entry)
        _count(bilstm_train_bwd_cuda, xg)
        entry = f"lstm_train_bwd_recurrence_{variant}"
        status = getattr(lib, entry)(w_hh.data_ptr(), *[t.data_ptr() for t in pointers],
                                     batch, time, hidden, stream)
        check(lib, status, entry)
        _count(bilstm_train_bwd_cuda, xg)
    return dg


bilstm_train_bwd_cuda.launches = bilstm_train_bwd_cuda.launches_bf16 = 0


class BiLSTMFunction(torch.autograd.Function):
    """One bidirectional layer with the training kernel pair: the
    counterpart of ``_bilstm_op`` (``lstm_pallas.py:482-573``).

    Forward: ``xg`` by a matmul, then the state-saving recurrence; ``xg``,
    the states, ``x`` and the lengths are saved. Backward: the dG kernels
    (two launches), then ``dW_ih = dG^T x``, ``dW_hh = dG^T h_prev``,
    ``d bias = sum dG`` and ``dx = dG W_ih`` as plain products. The bias is
    ``b_ih + b_hh``, so both get ``sum dG``.

    With ``bf16`` (``_bilstm_op(True, ...)``) the projection takes bf16
    operands with float32 accumulation and streams ``xg`` in bf16, the
    kernels run their bf16 variants (bf16 states, ``dout`` and dG), the
    weight and input gradients are products of bf16 operands with float32
    results (``lstm_pallas.py:523-528``) and ``d bias`` sums the bf16 dG
    in float32 (``:560``).
    """

    @staticmethod
    def forward(ctx, w_ih, w_hh, bias, x, lengths, bf16=False):
        w_hh = w_hh.contiguous()
        if bf16 and x.device.type == "cuda":
            fwd_mma_plan(x.shape[0], w_hh.shape[2])  # raises before anything is launched
        xg = project_inputs(w_ih, bias, x, torch.bfloat16 if bf16 else None).contiguous()
        out, h_prev, c_prev = bilstm_train_fwd_cuda(xg, w_hh, lengths)
        ctx.save_for_backward(w_ih, w_hh, x, lengths, xg, h_prev, c_prev)
        return out

    @staticmethod
    def backward(ctx, dout):
        w_ih, w_hh, x, lengths, xg, h_prev, c_prev = ctx.saved_tensors
        _, batch, time, gates4 = xg.shape
        bf16 = xg.dtype == torch.bfloat16
        dg = bilstm_train_bwd_cuda(xg, w_hh, lengths, h_prev, c_prev,
                                   dout.to(xg.dtype).contiguous())
        dg2 = dg.reshape(2, batch * time, gates4)
        mm = matmul_f32 if bf16 else torch.matmul
        x2 = x.reshape(1, batch * time, -1)
        d_w_ih = d_w_hh = d_bias = d_x = None
        if ctx.needs_input_grad[0]:
            d_w_ih = mm(dg2.transpose(1, 2), x2.expand(2, -1, -1) if bf16 else x2)
        if ctx.needs_input_grad[1]:
            d_w_hh = mm(dg2.transpose(1, 2), h_prev.reshape(2, batch * time, -1))
        if ctx.needs_input_grad[2]:
            d_bias = (dg2.float() if bf16 else dg2).sum(dim=1)
        if ctx.needs_input_grad[3]:
            d_x = mm(dg2, w_ih).sum(dim=0).reshape(x.shape)
        return d_w_ih, d_w_hh, d_bias, d_x, None, None


def bilstm_train_cuda(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                      x: torch.Tensor, lengths: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable bidirectional layer ``[B, T, D] -> [B, T, 2H]``,
    weights as :func:`bilstm_cuda` takes them (:class:`BiLSTMFunction`);
    ``compute_dtype=torch.bfloat16`` runs its bf16 mode."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"bilstm_train_cuda: compute dtype {compute_dtype}: only bfloat16 or None")
    return BiLSTMFunction.apply(w_ih, w_hh, bias, x, lengths, compute_dtype == torch.bfloat16)
