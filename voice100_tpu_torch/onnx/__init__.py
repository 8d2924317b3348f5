"""ONNX export, runtime and serving (no onnx package needed).

Port of ``voice100_tpu/onnx/``. The reference's serving contract is ONNX
consumed by voice100-runtime (voice100/export_onnx.py:12-161). This
package emits wire-valid ONNX (opset 13, dynamic batch and time axes)
from a port model's weights through protobuf classes made from a
descriptor built in code (:mod:`.schema`, no ``protoc``), and holds a NumPy evaluator that runs the emitted
graphs (:mod:`.runtime`, the stand-in for onnxruntime) and the serving
classes on top of it (:mod:`.serve`).
"""

from .builder import GraphBuilder  # noqa: F401
from .export import export_onnx  # noqa: F401
