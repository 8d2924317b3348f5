"""The ONNX messages the emitter and the runtime use, as protobuf classes.

The JAX package compiles ``voice100_tpu/onnx/voice100_onnx.proto`` (a
wire-compatible subset of the public ONNX schema) with ``protoc`` at
first use (``voice100_tpu/onnx/schema.py``). ``protoc`` is not everywhere
the port runs, so the port describes the same file in code (a
``FileDescriptorProto``: the messages, field numbers, types, oneofs and
enums of that ``.proto``) and has the ``protobuf`` runtime make the
classes from it. The bytes are protobuf's own, so any protobuf reader
(onnx, onnxruntime, the JAX package's generated module) reads them. The
descriptor lives in a pool of its own, so it does not collide with the
JAX package's generated module in one process.

:func:`get_pb` returns this module, which has the message classes under
the names the generated module would have (``ModelProto``, ``GraphProto``,
``NodeProto``, ``AttributeProto``, ``TensorProto``, ``ValueInfoProto``,
``TypeProto``, ``TensorShapeProto``, ``OperatorSetIdProto``,
``StringStringEntryProto``).
"""

from __future__ import annotations

import sys

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

__all__ = ["get_pb", "ModelProto", "GraphProto", "NodeProto", "AttributeProto", "TensorProto",
           "ValueInfoProto", "TypeProto", "TensorShapeProto", "OperatorSetIdProto",
           "StringStringEntryProto"]

_PACKAGE = "voice100_onnx"
_SCALARS = {"double": 1, "float": 2, "int64": 3, "uint64": 4, "int32": 5, "string": 9,
            "bytes": 12}
_ENUMS = {
    "AttributeProto.AttributeType": ("UNDEFINED", "FLOAT", "INT", "STRING", "TENSOR", "GRAPH",
                                     "FLOATS", "INTS", "STRINGS", "TENSORS", "GRAPHS"),
    "TensorProto.DataType": ("UNDEFINED", "FLOAT", "UINT8", "INT8", "UINT16", "INT16", "INT32",
                             "INT64", "STRING", "BOOL", "FLOAT16", "DOUBLE", "UINT32", "UINT64",
                             "COMPLEX64", "COMPLEX128", "BFLOAT16"),
}
_R, _ONEOF = "repeated", "oneof value"
# message -> fields (name, number, type[, _R or _ONEOF]), as voice100_onnx.proto
_MESSAGES = {
    "AttributeProto": (
        ("name", 1, "string"), ("f", 2, "float"), ("i", 3, "int64"), ("s", 4, "bytes"),
        ("t", 5, "TensorProto"), ("g", 6, "GraphProto"), ("floats", 7, "float", _R),
        ("ints", 8, "int64", _R), ("strings", 9, "bytes", _R), ("tensors", 10, "TensorProto", _R),
        ("graphs", 11, "GraphProto", _R), ("doc_string", 13, "string"),
        ("type", 20, "AttributeProto.AttributeType")),
    "ValueInfoProto": (("name", 1, "string"), ("type", 2, "TypeProto"),
                       ("doc_string", 3, "string")),
    "NodeProto": (
        ("input", 1, "string", _R), ("output", 2, "string", _R), ("name", 3, "string"),
        ("op_type", 4, "string"), ("attribute", 5, "AttributeProto", _R),
        ("doc_string", 6, "string"), ("domain", 7, "string")),
    "ModelProto": (
        ("ir_version", 1, "int64"), ("producer_name", 2, "string"),
        ("producer_version", 3, "string"), ("domain", 4, "string"),
        ("model_version", 5, "int64"), ("doc_string", 6, "string"), ("graph", 7, "GraphProto"),
        ("opset_import", 8, "OperatorSetIdProto", _R),
        ("metadata_props", 14, "StringStringEntryProto", _R)),
    "StringStringEntryProto": (("key", 1, "string"), ("value", 2, "string")),
    "GraphProto": (
        ("node", 1, "NodeProto", _R), ("name", 2, "string"), ("initializer", 5, "TensorProto", _R),
        ("doc_string", 10, "string"), ("input", 11, "ValueInfoProto", _R),
        ("output", 12, "ValueInfoProto", _R), ("value_info", 13, "ValueInfoProto", _R)),
    "TensorProto": (
        ("dims", 1, "int64", _R), ("data_type", 2, "int32"), ("float_data", 4, "float", _R),
        ("int32_data", 5, "int32", _R), ("string_data", 6, "bytes", _R),
        ("int64_data", 7, "int64", _R), ("name", 8, "string"), ("raw_data", 9, "bytes"),
        ("double_data", 10, "double", _R), ("uint64_data", 11, "uint64", _R),
        ("doc_string", 12, "string")),
    "TensorShapeProto": (("dim", 1, "TensorShapeProto.Dimension", _R),),
    "TensorShapeProto.Dimension": (("dim_value", 1, "int64", _ONEOF),
                                   ("dim_param", 2, "string", _ONEOF),
                                   ("denotation", 3, "string")),
    "TypeProto": (("tensor_type", 1, "TypeProto.Tensor", _ONEOF), ("denotation", 6, "string")),
    "TypeProto.Tensor": (("elem_type", 1, "int32"), ("shape", 2, "TensorShapeProto")),
    "OperatorSetIdProto": (("domain", 1, "string"), ("version", 2, "int64")),
}


def _file_descriptor() -> descriptor_pb2.FileDescriptorProto:
    """``voice100_onnx.proto`` as a descriptor (proto3: repeated numbers
    packed, a singular scalar written where it is not its default)."""
    fd = descriptor_pb2.FileDescriptorProto(name="voice100_onnx.proto", package=_PACKAGE,
                                            syntax="proto3")
    made = {}
    for path in _MESSAGES:  # a nested message follows its parent
        parent, _, name = path.rpartition(".")
        made[path] = (made[parent].nested_type if parent else fd.message_type).add(name=name)
    for path, values in _ENUMS.items():
        parent, _, name = path.rpartition(".")
        enum = made[parent].enum_type.add(name=name)
        for number, value in enumerate(values):
            enum.value.add(name=value, number=number)
    F = descriptor_pb2.FieldDescriptorProto
    for path, fields in _MESSAGES.items():
        message = made[path]
        for name, number, kind, *flag in fields:
            field = message.field.add(name=name, number=number,
                                      label=F.LABEL_REPEATED if _R in flag else F.LABEL_OPTIONAL)
            if kind in _SCALARS:
                field.type = _SCALARS[kind]
            else:
                field.type = F.TYPE_ENUM if kind in _ENUMS else F.TYPE_MESSAGE
                field.type_name = f".{_PACKAGE}.{kind}"
            if _ONEOF in flag:
                if not message.oneof_decl:
                    message.oneof_decl.add(name="value")
                field.oneof_index = 0
    return fd


_POOL = descriptor_pool.DescriptorPool()
_POOL.Add(_file_descriptor())
for _name in __all__[1:]:
    globals()[_name] = message_factory.GetMessageClass(
        _POOL.FindMessageTypeByName(f"{_PACKAGE}.{_name}"))


def get_pb():
    """The message classes (this module), in the place of the generated
    protobuf module the JAX package's ``get_pb`` returns."""
    return sys.modules[__name__]
