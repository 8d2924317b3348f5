"""Small ONNX graph builder over the bundled schema subset.

A copy of ``voice100_tpu/onnx/builder.py`` on the port's schema
(:mod:`voice100_tpu_torch.onnx.schema`, protobuf classes made from a
descriptor built in code). Covers what the reference's exported graphs need
(voice100/export_onnx.py:21-37): float/int tensors, initializers from
NumPy arrays, dynamic (named) dimensions, node attributes of int /
ints / float / string type.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np

from .schema import get_pb

__all__ = ["GraphBuilder", "DT_FLOAT", "DT_INT32", "DT_INT64", "DT_BOOL"]

DT_FLOAT = 1
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL,
}

Dim = Union[int, str]


class GraphBuilder:
    """Accumulates nodes/initializers/IO and serializes a ModelProto."""

    def __init__(self, name: str, doc: str = "") -> None:
        self._pb = get_pb()
        self.model = self._pb.ModelProto()
        self.model.ir_version = 7  # IR version for opset 13
        self.model.producer_name = "voice100_tpu"
        self.model.producer_version = "1.0"
        opset = self.model.opset_import.add()
        opset.domain = ""
        opset.version = 13
        self.graph = self.model.graph
        self.graph.name = name
        if doc:
            self.graph.doc_string = doc
        self._counter = 0

    # -- naming ---------------------------------------------------------
    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    # -- tensors --------------------------------------------------------
    def _fill_value_info(self, vi, name: str, dtype: int,
                         shape: Sequence[Dim]) -> None:
        vi.name = name
        tt = vi.type.tensor_type
        tt.elem_type = dtype
        for d in shape:
            dim = tt.shape.dim.add()
            if isinstance(d, str):
                dim.dim_param = d
            else:
                dim.dim_value = int(d)

    def add_input(self, name: str, dtype: int, shape: Sequence[Dim]) -> str:
        self._fill_value_info(self.graph.input.add(), name, dtype, shape)
        return name

    def add_output(self, name: str, dtype: int, shape: Sequence[Dim]) -> str:
        self._fill_value_info(self.graph.output.add(), name, dtype, shape)
        return name

    def add_initializer(self, name: str, array: np.ndarray) -> str:
        array = np.ascontiguousarray(array)
        dt = _NP_TO_DT.get(array.dtype)
        if dt is None:
            raise ValueError(f"unsupported initializer dtype {array.dtype}")
        t = self.graph.initializer.add()
        t.name = name
        t.data_type = dt
        t.dims.extend(array.shape)
        t.raw_data = array.tobytes()
        return name

    def constant(self, hint: str, array: np.ndarray) -> str:
        return self.add_initializer(self.fresh(hint), np.asarray(array))

    # -- nodes ----------------------------------------------------------
    def node(
        self,
        op_type: str,
        inputs: Iterable[str],
        n_outputs: int = 1,
        outputs: Optional[Sequence[str]] = None,
        **attrs,
    ):
        """Append a node; returns its output name (or tuple of names)."""
        node = self.graph.node.add()
        node.op_type = op_type
        node.name = self.fresh(op_type)
        node.input.extend(inputs)
        if outputs is None:
            outputs = [
                self.fresh(f"{op_type.lower()}_out")
                for _ in range(n_outputs)
            ]
        node.output.extend(outputs)
        for key, value in attrs.items():
            if value is None:
                continue
            attr = node.attribute.add()
            attr.name = key
            if isinstance(value, bool):
                attr.type = self._pb.AttributeProto.INT
                attr.i = int(value)
            elif isinstance(value, int):
                attr.type = self._pb.AttributeProto.INT
                attr.i = value
            elif isinstance(value, float):
                attr.type = self._pb.AttributeProto.FLOAT
                attr.f = value
            elif isinstance(value, str):
                attr.type = self._pb.AttributeProto.STRING
                attr.s = value.encode("utf-8")
            elif isinstance(value, (list, tuple)) and all(
                isinstance(v, int) for v in value
            ):
                attr.type = self._pb.AttributeProto.INTS
                attr.ints.extend(value)
            elif isinstance(value, (list, tuple)) and all(
                isinstance(v, float) for v in value
            ):
                attr.type = self._pb.AttributeProto.FLOATS
                attr.floats.extend(value)
            elif isinstance(value, (list, tuple)) and all(
                isinstance(v, str) for v in value
            ):
                attr.type = self._pb.AttributeProto.STRINGS
                attr.strings.extend(v.encode("utf-8") for v in value)
            else:
                raise ValueError(f"unsupported attribute {key}={value!r}")
        if len(outputs) == 1:
            return outputs[0]
        return tuple(outputs)

    # -- serialization ---------------------------------------------------
    def serialize(self) -> bytes:
        return self.model.SerializeToString()

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.serialize())
        return path
