"""NumPy evaluator for the ONNX graphs this framework emits.

A copy of ``voice100_tpu/onnx/runtime.py`` on the port's schema
(:mod:`voice100_tpu_torch.onnx.schema`); it reads files of either
package's emitter. The reference's serving story hands its ONNX files to onnxruntime via
the separate voice100-runtime project (README.md:289-291). This module
is the framework's self-contained equivalent: a reference interpreter
covering the operator subset produced by ``onnx/export.py`` — enough to
validate round-trip numerics without onnxruntime and to serve on any
CPU host.

Semantics notes:
- ``LSTM`` implements bidirectional recurrence with ``sequence_lens``
  masking; outputs past a sequence's length are zero (matching both
  onnxruntime and this framework's masked scan).
- Integer ``Div`` truncates toward zero (C semantics), as in ONNX.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .schema import get_pb

__all__ = ["OnnxModel", "load_model"]

_DT_TO_NP = {
    1: np.float32,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    11: np.float64,
}


def _tensor_to_np(t) -> np.ndarray:
    dtype = _DT_TO_NP[t.data_type]
    shape = tuple(t.dims)
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dtype).reshape(shape).copy()
    if t.data_type == 1:
        return np.asarray(t.float_data, np.float32).reshape(shape)
    if t.data_type == 6:
        return np.asarray(t.int32_data, np.int32).reshape(shape)
    if t.data_type == 7:
        return np.asarray(t.int64_data, np.int64).reshape(shape)
    raise ValueError(f"unsupported tensor proto (dtype {t.data_type})")


def _attrs(node) -> Dict[str, object]:
    pb = get_pb()
    out: Dict[str, object] = {}
    for a in node.attribute:
        if a.type == pb.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == pb.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == pb.AttributeProto.STRING:
            out[a.name] = a.s.decode("utf-8")
        elif a.type == pb.AttributeProto.INTS:
            out[a.name] = list(a.ints)
        elif a.type == pb.AttributeProto.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == pb.AttributeProto.TENSOR:
            out[a.name] = _tensor_to_np(a.t)
        else:
            raise ValueError(f"unsupported attribute type {a.type}")
    return out


def _conv1d(x, w, b, stride, pads, groups=1, dilation=1):
    """x [B, C, T], w [O, C/g, K] -> [B, O, T']."""
    batch, c_in, time = x.shape
    out_ch, _, k = w.shape
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[1])))
    k_span = (k - 1) * dilation + 1
    t_out = (x.shape[2] - k_span) // stride + 1
    idx = (np.arange(t_out)[None, :] * stride
           + np.arange(k)[:, None] * dilation)
    col = x[:, :, idx]  # [B, C, K, T']
    if groups == 1:
        y = np.einsum("bckt,ock->bot", col, w, optimize=True)
    else:
        cpg = c_in // groups
        opg = out_ch // groups
        col = col.reshape(batch, groups, cpg, k, t_out)
        wg = w.reshape(groups, opg, cpg, k)
        y = np.einsum("bgckt,gock->bgot", col, wg, optimize=True)
        y = y.reshape(batch, out_ch, t_out)
    if b is not None:
        y = y + b[None, :, None]
    return np.ascontiguousarray(y, dtype=np.float32)


def _conv_transpose1d(x, w, b, stride, pads):
    """x [B, C, T], w [C, O, K] -> [B, O, (T-1)*s - pads_sum + K]."""
    batch, _, time = x.shape
    _, out_ch, k = w.shape
    t_full = (time - 1) * stride + k
    y = np.zeros((batch, out_ch, t_full), np.float32)
    # scatter each input step's contribution
    contrib = np.einsum("bct,cok->botk", x, w, optimize=True)
    for t in range(time):
        y[:, :, t * stride:t * stride + k] += contrib[:, :, t, :]
    y = y[:, :, pads[0]:t_full - pads[1]]
    if b is not None:
        y = y + b[None, :, None]
    return np.ascontiguousarray(y, dtype=np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _lstm_bidirectional(x, w, r, b, seq_lens, hidden):
    """x [T, B, D]; w [2, 4H, D]; r [2, 4H, H]; b [2, 8H] (iofc order).

    Returns Y [T, 2, B, H] with zeros past each sequence's length.
    """
    time, batch, _ = x.shape
    y = np.zeros((time, 2, batch, hidden), np.float32)
    for d, reverse in ((0, False), (1, True)):
        wd, rd, bd = w[d], r[d], b[d]
        bias = bd[: 4 * hidden] + bd[4 * hidden:]
        xg = x @ wd.T + bias  # [T, B, 4H]
        h = np.zeros((batch, hidden), np.float32)
        c = np.zeros((batch, hidden), np.float32)
        steps = range(time - 1, -1, -1) if reverse else range(time)
        for t in steps:
            g = xg[t] + h @ rd.T
            i = _sigmoid(g[:, 0 * hidden:1 * hidden])
            o = _sigmoid(g[:, 1 * hidden:2 * hidden])
            f = _sigmoid(g[:, 2 * hidden:3 * hidden])
            cc = np.tanh(g[:, 3 * hidden:4 * hidden])
            c_new = f * c + i * cc
            h_new = o * np.tanh(c_new)
            valid = (t < seq_lens)[:, None]
            h = np.where(valid, h_new, h)
            c = np.where(valid, c_new, c)
            y[t, d] = np.where(valid, h_new, 0.0)
    return y


class OnnxModel:
    """A parsed ONNX model runnable on NumPy inputs."""

    def __init__(self, model_proto) -> None:
        self.proto = model_proto
        g = model_proto.graph
        self.initializers = {t.name: _tensor_to_np(t) for t in g.initializer}
        self.input_names = [
            vi.name for vi in g.input if vi.name not in self.initializers
        ]
        self.output_names = [vi.name for vi in g.output]
        self.nodes = list(g.node)

    def __call__(self, *args: np.ndarray, **kwargs: np.ndarray):
        env: Dict[str, np.ndarray] = dict(self.initializers)
        if args:
            if len(args) != len(self.input_names):
                raise ValueError(
                    f"expected {len(self.input_names)} inputs "
                    f"({self.input_names}), got {len(args)}"
                )
            env.update(zip(self.input_names, map(np.asarray, args)))
        env.update({k: np.asarray(v) for k, v in kwargs.items()})
        for node in self.nodes:
            outs = self._run_node(node, [env[i] if i else None
                                         for i in node.input])
            for name, value in zip(node.output, outs):
                env[name] = value
        return tuple(env[name] for name in self.output_names)

    def _run_node(self, node, inputs: List[np.ndarray]) -> Sequence:
        op = node.op_type
        a = _attrs(node)
        x = inputs[0]
        if op == "Identity":
            return (x,)
        if op == "Add":
            return (x + inputs[1],)
        if op == "Sub":
            return (x - inputs[1],)
        if op == "Mul":
            return (x * inputs[1],)
        if op == "Div":
            if np.issubdtype(x.dtype, np.integer):
                return ((np.abs(x) // np.abs(inputs[1])
                         * np.sign(x) * np.sign(inputs[1])
                         ).astype(x.dtype),)
            return (x / inputs[1],)
        if op == "MatMul":
            return (np.matmul(x, inputs[1]),)
        if op == "Sqrt":
            return (np.sqrt(x),)
        if op == "Erf":
            from math import erf

            return (np.vectorize(erf, otypes=[np.float32])(x),)
        if op == "Exp":
            return (np.exp(x),)
        if op == "Sigmoid":
            return (_sigmoid(x),)
        if op == "Tanh":
            return (np.tanh(x),)
        if op == "Relu":
            return (np.maximum(x, 0),)
        if op == "Less":
            return (x < inputs[1],)
        if op == "Greater":
            return (x > inputs[1],)
        if op == "Where":
            return (np.where(x, inputs[1], inputs[2]),)
        if op == "ReduceMean":
            axes = tuple(a["axes"])
            return (np.mean(x, axis=axes,
                            keepdims=bool(a.get("keepdims", 1)),
                            dtype=x.dtype),)
        if op == "Transpose":
            return (np.transpose(x, a["perm"]),)
        if op == "Reshape":
            shape = [int(s) for s in inputs[1]]
            shape = [x.shape[i] if s == 0 else s
                     for i, s in enumerate(shape)]
            return (x.reshape(shape),)
        if op == "Gather":
            return (np.take(x, inputs[1], axis=a.get("axis", 0)),)
        if op == "Concat":
            return (np.concatenate(inputs, axis=a["axis"]),)
        if op == "Slice":
            starts, ends = inputs[1], inputs[2]
            axes = (inputs[3] if len(inputs) > 3 and inputs[3] is not None
                    else np.arange(len(starts)))
            steps = (inputs[4] if len(inputs) > 4 and inputs[4] is not None
                     else np.ones(len(starts), np.int64))
            slicer = [slice(None)] * x.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                slicer[int(ax)] = slice(int(s), int(e), int(st))
            return (x[tuple(slicer)],)
        if op == "Squeeze":
            axes = tuple(int(v) for v in inputs[1])
            return (np.squeeze(x, axis=axes),)
        if op == "Unsqueeze":
            y = x
            for ax in sorted(int(v) for v in inputs[1]):
                y = np.expand_dims(y, ax)
            return (y,)
        if op == "Cast":
            return (x.astype(_DT_TO_NP[a["to"]]),)
        if op == "Clip":
            lo = inputs[1] if len(inputs) > 1 and inputs[1] is not None \
                else -np.inf
            hi = inputs[2] if len(inputs) > 2 and inputs[2] is not None \
                else np.inf
            return (np.clip(x, lo, hi),)
        if op == "Conv":
            w = inputs[1]
            b = inputs[2] if len(inputs) > 2 else None
            return (_conv1d(
                x, w, b, a["strides"][0], a["pads"],
                groups=a.get("group", 1),
                dilation=a.get("dilations", [1])[0],
            ),)
        if op == "ConvTranspose":
            w = inputs[1]
            b = inputs[2] if len(inputs) > 2 else None
            return (_conv_transpose1d(x, w, b, a["strides"][0], a["pads"]),)
        if op == "LSTM":
            if a.get("direction") != "bidirectional":
                raise NotImplementedError("only bidirectional LSTM")
            y = _lstm_bidirectional(
                x, inputs[1], inputs[2], inputs[3],
                np.asarray(inputs[4], np.int64), a["hidden_size"],
            )
            # Y_h / Y_c are unused by our graphs; return zeros
            n_dir, batch, hidden = 2, x.shape[1], a["hidden_size"]
            z = np.zeros((n_dir, batch, hidden), np.float32)
            return (y, z, z)
        raise NotImplementedError(f"op {op} not supported by this runtime")


def load_model(path: str) -> OnnxModel:
    pb = get_pb()
    proto = pb.ModelProto()
    with open(path, "rb") as f:
        proto.ParseFromString(f.read())
    return OnnxModel(proto)
