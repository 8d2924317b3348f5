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
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["lstm_direction", "stack_directions", "project_inputs", "bilstm",
           "bilstm_train_fwd", "bilstm_train_bwd"]

Params = Dict[str, torch.Tensor]


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


def project_inputs(w_ih: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Both directions' gate inputs ``x @ W_ih^T + b``: ``[2, B, T, 4H]``,
    one batched matmul (``_dir_xg``, ``lstm_pallas.py:466-479``)."""
    batch, time, d_in = x.shape
    xg = torch.matmul(x.reshape(1, batch * time, d_in), w_ih.transpose(1, 2)) + bias[:, None, :]
    return xg.reshape(2, batch, time, w_ih.shape[1])


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
    """
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
    return out, _to_source_time(hs), _to_source_time(cs)


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
    """
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
    return _to_source_time(dgs)


def bilstm(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
           x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional layer: ``[B, T, D] -> [B, T, 2H]``, concat(fwd, bwd).

    Weights as :func:`stack_directions` gives them. Both directions
    advance in one loop, their recurrent products one batched matmul
    ``[2, B, H] x [2, H, 4H]`` a step, as the JAX scan does.
    Differentiable by autograd.
    """
    return bilstm_train_fwd(project_inputs(w_ih, bias, x), w_hh, lengths)[0]
