"""Length-masked (bi)LSTM, plain PyTorch.

Port of ``voice100_tpu/ops/lstm.py:101-226`` and of the train kernel
pair's semantics (``voice100_tpu/ops/lstm_pallas.py:232-321``).
Sequences stay padded and packed-sequence semantics are reproduced with
masks: the state freezes past each sequence's length, outputs there are
zero, and the backward direction starts from the true end of each
sequence. The input projection ``x @ W_ih^T + b_ih + b_hh`` is one
matmul over the whole sequence; the loop carries only ``h @ W_hh^T``.
Weight layout and gate order (i, f, g, o) follow ``torch.nn.LSTM``.

Both directions are kept in natural time: step ``s`` of the loop reads
and writes source time ``s`` for the forward direction and ``T-1-s`` for
the backward one, so every ``[2, B, T, *]`` tensor here is indexed by
source time in both directions and the weight gradients are plain
products over ``(B, T)``.

:func:`bilstm`, :func:`bilstm_train_fwd` and :func:`bilstm_train_bwd`
are the plain versions of the CUDA kernels (``ops/lstm_cuda.py``), whose
wrappers run them for tensors on the CPU.

The bf16 mixed-precision mode (``voice100_tpu/ops/lstm.py:40-62``,
``lstm_pallas.py:131-146, 232-321, 466-570``) is the process default
:func:`set_default_compute_dtype` sets, else
``VOICE100_TPU_MATMUL_DTYPE=bfloat16``. It rounds at the JAX Pallas
path's points and nowhere else: the gate inputs ``xg`` stream in bf16
(the inference path rounds a float32 projection, the training path
projects bf16 operands with float32 accumulation), the training forward
saves its states in bf16, and the backward reads bf16 ``dout`` and stores
dG in bf16. Each recurrence, its carries and its gates stay float32.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

__all__ = ["lstm_direction", "stack_directions", "project_inputs", "bilstm",
           "bilstm_train_fwd", "bilstm_train_bwd", "set_default_compute_dtype",
           "default_compute_dtype", "matmul_f32"]

Params = Dict[str, torch.Tensor]

# The process default of the mixed-precision mode (None: float32), set by
# the trainer's ``precision`` before a fit; VOICE100_TPU_MATMUL_DTYPE is
# the fallback for serving.
_DEFAULT_COMPUTE_DTYPE: Optional[torch.dtype] = None


def set_default_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    """Set the process default compute dtype: ``torch.bfloat16`` for the
    mixed-precision mode, ``None`` to restore float32."""
    global _DEFAULT_COMPUTE_DTYPE
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: only torch.bfloat16 or None")
    _DEFAULT_COMPUTE_DTYPE = dtype


def default_compute_dtype() -> Optional[torch.dtype]:
    """``torch.bfloat16`` when the process default or
    ``VOICE100_TPU_MATMUL_DTYPE=bfloat16`` asks for the mixed-precision
    mode, else ``None``."""
    if _DEFAULT_COMPUTE_DTYPE is not None:
        return _DEFAULT_COMPUTE_DTYPE
    name = os.environ.get("VOICE100_TPU_MATMUL_DTYPE", "")
    return torch.bfloat16 if name == "bfloat16" else None


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched product ``a @ b`` (3-D, equal batch) of the bf16-rounded
    operands with a float32 result, as ``jnp.einsum(...,
    preferred_element_type=jnp.float32)`` on bf16 arrays. On the card one
    cuBLAS bf16 product with float32 output; on the CPU, which has no such
    product, the operands widened back to float32 (a product of two bf16
    values is exact in float32, and the sums are float32 either way)."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _cell(gates: torch.Tensor, c_prev: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_direction(params: Params, x: torch.Tensor, lengths: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """One direction of a masked LSTM layer.

    Args:
        params: ``w_ih [4H, D]``, ``w_hh [4H, H]``, ``b_ih``, ``b_hh``.
        x: ``[B, T, D]`` padded inputs.
        lengths: ``[B]`` valid lengths.
        reverse: run right to left (the backward direction).

    Returns:
        ``[B, T, H]`` outputs, zero at padding positions.
    """
    batch, time, _ = x.shape
    hidden = params["w_hh"].shape[1]
    xg = x @ params["w_ih"].T + params["b_ih"] + params["b_hh"]  # [B, T, 4H]
    w_hh_t = params["w_hh"].T
    valid = (torch.arange(time, device=x.device)[:, None]
             < lengths.to(x.device)[None, :]).to(x.dtype)[:, :, None]  # [T, B, 1]
    h = x.new_zeros(batch, hidden)
    c = x.new_zeros(batch, hidden)
    out = x.new_zeros(batch, time, hidden)
    for t in (range(time - 1, -1, -1) if reverse else range(time)):
        h_new, c_new = _cell(xg[:, t] + h @ w_hh_t, c)
        v = valid[t]
        h = v * h_new + (1.0 - v) * h
        c = v * c_new + (1.0 - v) * c
        out[:, t] = h * v
    return out


def stack_directions(layer_params: Dict[str, Params]):
    """``fwd`` and ``bwd`` dicts of one layer -> ``(w_ih [2, 4H, D],
    w_hh [2, 4H, H], bias [2, 4H])``, forward direction first and
    ``bias = b_ih + b_hh``: the weights :func:`bilstm` and the CUDA
    wrappers take."""
    fwd, bwd = layer_params["fwd"], layer_params["bwd"]
    return (torch.stack([fwd["w_ih"], bwd["w_ih"]]),
            torch.stack([fwd["w_hh"], bwd["w_hh"]]),
            torch.stack([fwd["b_ih"] + fwd["b_hh"], bwd["b_ih"] + bwd["b_hh"]]))


def project_inputs(w_ih: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Both directions' gate inputs ``x @ W_ih^T + b``: ``[2, B, T, 4H]``,
    one batched matmul (``_dir_xg``, ``lstm_pallas.py:466-479``).

    ``compute_dtype=torch.bfloat16`` is the training path's bf16 mode:
    bf16 operands with float32 accumulation, the biases added in float32,
    the sum rounded to bf16 (a bf16 result)."""
    batch, time, d_in = x.shape
    x2 = x.reshape(1, batch * time, d_in)
    if compute_dtype == torch.bfloat16:
        prod = matmul_f32(x2.expand(2, -1, -1), w_ih.transpose(1, 2))
        xg = (prod + bias[:, None, :]).to(torch.bfloat16)
    else:
        xg = torch.matmul(x2, w_ih.transpose(1, 2)) + bias[:, None, :]
    return xg.reshape(2, batch, time, w_ih.shape[1])


def _widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor widened to float32; any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _valid_steps(time: int, lengths: torch.Tensor, device) -> torch.Tensor:
    """``[T, 2, B, 1]`` float mask of loop step ``s``: source time ``s``
    (forward) or ``T-1-s`` (backward) lies inside the sequence."""
    t_all = torch.arange(time, device=device)
    src = torch.stack([t_all, time - 1 - t_all], dim=1)  # [T, 2]
    return (src[:, :, None] < lengths.to(device)[None, None, :]).float()[..., None]


def _at_step(a: torch.Tensor, s: int) -> torch.Tensor:
    """``[2, B, T, *]`` in source time -> ``[2, B, *]`` at loop step ``s``."""
    return torch.stack([a[0, :, s], a[1, :, a.shape[2] - 1 - s]])


def _to_source_time(steps: List[torch.Tensor]) -> torch.Tensor:
    """``T`` tensors ``[2, B, *]`` in loop-step order -> ``[2, B, T, *]``
    in source time."""
    stacked = torch.stack(steps, dim=2)
    return torch.stack([stacked[0], stacked[1].flip(1)])


def bilstm_train_fwd(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """The state-saving recurrence of both directions (kernel 2's plain
    version; ``_kernel_train_fwd``, ``lstm_pallas.py:232-264``).

    Args:
        xg: ``[2, B, T, 4H]`` gate inputs (:func:`project_inputs`).
        w_hh: ``[2, 4H, H]`` recurrent weights.
        lengths: ``[B]`` valid lengths.

    Returns:
        ``out [B, T, 2H]`` (concat of the directions, zero past each
        length) and ``h_prev, c_prev [2, B, T, H]``: the state entering
        the step at each source time, before its update (past a length
        the frozen state, as the JAX kernel saves it).

    A bf16 ``xg`` is the bf16 mode: it is widened to float32, the
    recurrence and ``out`` are float32, and the states are saved rounded
    to bf16 (``state_dtype``, ``lstm_pallas.py:259-264``).
    """
    state_dtype = xg.dtype
    xg = _widen(xg)
    _, batch, time, gates4 = xg.shape
    hidden = gates4 // 4
    w_hh_t = w_hh.transpose(1, 2)  # [2, H, 4H]
    valid = _valid_steps(time, lengths, xg.device)
    h = xg.new_zeros(2, batch, hidden)
    c = xg.new_zeros(2, batch, hidden)
    outs, hs, cs = [], [], []
    for s in range(time):
        hs.append(h)
        cs.append(c)
        h_new, c_new = _cell(_at_step(xg, s) + torch.bmm(h, w_hh_t), c)
        v = valid[s]
        h = v * h_new + (1.0 - v) * h
        c = v * c_new + (1.0 - v) * c
        outs.append(h * v)
    out = _to_source_time(outs).permute(1, 2, 0, 3).reshape(batch, time, 2 * hidden)
    return out, _to_source_time(hs).to(state_dtype), _to_source_time(cs).to(state_dtype)


def bilstm_train_bwd(xg: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
                     h_prev: torch.Tensor, c_prev: torch.Tensor,
                     dout: torch.Tensor) -> torch.Tensor:
    """dG, the gradient of the gate pre-activations ``[2, B, T, 4H]``
    (kernel 3's plain version; ``_kernel_train_bwd``,
    ``lstm_pallas.py:267-321``).

    Two phases, split as the data dependencies split and as the kernel
    splits them. First the gates of every step at once,
    ``xg + h_prev W_hh^T`` from the saved pre-update states: they do not
    depend on the adjoint. Then the loop steps in reverse, carrying only
    ``(dh, dc)``: the output gradient enters as ``v * (dh + dout)``, and a
    frozen step (``v = 0``) passes ``dh`` and ``dc`` through unchanged.
    ``dout`` is ``[B, T, 2H]``, the gradient of :func:`bilstm_train_fwd`'s
    ``out``.

    A bf16 ``xg`` is the bf16 mode (``lstm_pallas.py:281-319``): ``xg``,
    the bf16-stored states and ``dout`` (bf16 too) are widened to float32,
    the gates, the carries and the ``dh`` product use the float32 dG, and
    only the returned dG is rounded to bf16.
    """
    dg_dtype = xg.dtype
    xg, h_prev, c_prev, dout = (_widen(t) for t in (xg, h_prev, c_prev, dout))
    _, batch, time, gates4 = xg.shape
    hidden = gates4 // 4
    all_gates = xg + torch.matmul(h_prev, w_hh.transpose(1, 2)[:, None])  # [2, B, T, 4H]
    valid = _valid_steps(time, lengths, xg.device)
    dout = dout.reshape(batch, time, 2, hidden).permute(2, 0, 1, 3)  # [2, B, T, H]
    dh = xg.new_zeros(2, batch, hidden)
    dc = xg.new_zeros(2, batch, hidden)
    dgs = [None] * time
    for s in range(time - 1, -1, -1):
        c_p = _at_step(c_prev, s)
        gi, gf, gg, go = _at_step(all_gates, s).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        tanh_c = torch.tanh(f * c_p + i * g)
        v = valid[s]
        d_hcand = v * (dh + _at_step(dout, s))
        d_ccand = d_hcand * o * (1.0 - tanh_c * tanh_c) + v * dc
        da = torch.cat([d_ccand * g * i * (1.0 - i),
                        d_ccand * c_p * f * (1.0 - f),
                        d_ccand * i * (1.0 - g * g),
                        d_hcand * tanh_c * o * (1.0 - o)], dim=-1)
        dgs[s] = da
        dh = torch.bmm(da, w_hh) + (1.0 - v) * dh
        dc = d_ccand * f + (1.0 - v) * dc
    return _to_source_time(dgs).to(dg_dtype)


def bilstm(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
           x: torch.Tensor, lengths: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bidirectional layer: ``[B, T, D] -> [B, T, 2H]``, concat(fwd, bwd).

    Weights as :func:`stack_directions` gives them. Both directions
    advance in one loop, their recurrent products one batched matmul
    ``[2, B, H] x [2, H, 4H]`` a step, as the JAX scan does.
    Differentiable by autograd. ``compute_dtype=torch.bfloat16`` is the
    inference path's bf16 mode (kernel 1's, ``lstm_pallas.py:131-146``):
    the float32 projection is rounded to bf16; the recurrence stays
    float32.
    """
    xg = project_inputs(w_ih, bias, x)
    if compute_dtype == torch.bfloat16:
        xg = xg.to(torch.bfloat16)
    return bilstm_train_fwd(xg, w_hh, lengths)[0]
