"""Length-masked (bi)LSTM, plain PyTorch.

Port of ``voice100_tpu/ops/lstm.py:101-226``. Sequences stay padded and
packed-sequence semantics are reproduced with masks: the state freezes
past each sequence's length, outputs there are zero, and the backward
direction starts from the true end of each sequence. The input
projection ``x @ W_ih^T + b_ih + b_hh`` is one matmul over the whole
sequence; the loop carries only ``h @ W_hh^T``. Weight layout and gate
order (i, f, g, o) follow ``torch.nn.LSTM``.

:func:`bilstm` is the plain version of the CUDA recurrence kernel
(``ops/lstm_cuda.py``), whose wrapper runs it for tensors on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["lstm_direction", "stack_directions", "bilstm"]

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
    wrapper take."""
    fwd, bwd = layer_params["fwd"], layer_params["bwd"]
    return (torch.stack([fwd["w_ih"], bwd["w_ih"]]),
            torch.stack([fwd["w_hh"], bwd["w_hh"]]),
            torch.stack([fwd["b_ih"] + fwd["b_hh"], bwd["b_ih"] + bwd["b_hh"]]))


def bilstm(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
           x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional layer: ``[B, T, D] -> [B, T, 2H]``, concat(fwd, bwd).

    Weights as :func:`stack_directions` gives them. Both directions
    advance in one loop, their recurrent products one batched matmul
    ``[2, B, H] x [2, H, 4H]`` a step, as the JAX scan does.
    """
    batch, time, d_in = x.shape
    hidden = w_hh.shape[2]
    xg = (torch.matmul(x.reshape(1, batch * time, d_in), w_ih.transpose(1, 2))
          + bias[:, None, :]).reshape(2, batch, time, 4 * hidden)
    w_hh_t = w_hh.transpose(1, 2)  # [2, H, 4H]
    t_all = torch.arange(time, device=x.device)
    orig = torch.stack([t_all, time - 1 - t_all], dim=1)  # [T, 2] source step
    valid = (orig[:, :, None] < lengths.to(x.device)[None, None, :]
             ).to(x.dtype)[..., None]  # [T, 2, B, 1]
    h = x.new_zeros(2, batch, hidden)
    c = x.new_zeros(2, batch, hidden)
    out = x.new_zeros(batch, time, 2, hidden)
    for t in range(time):
        gates = torch.stack([xg[0, :, t], xg[1, :, time - 1 - t]]) + torch.bmm(h, w_hh_t)
        h_new, c_new = _cell(gates, c)
        v = valid[t]
        h = v * h_new + (1.0 - v) * h
        c = v * c_new + (1.0 - v) * c
        out[:, t, 0] = h[0] * v[0]
        out[:, time - 1 - t, 1] = h[1] * v[1]
    return out.reshape(batch, time, 2 * hidden)
