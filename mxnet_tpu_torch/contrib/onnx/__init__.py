"""ONNX interchange (reference: python/mxnet/contrib/onnx: mx2onnx
export_model and onnx2mx import_model).

Counterpart of ``mxnet_tpu/contrib/onnx/``.  The wire format is handled by
the port's own pure-Python codec, ``onnx_minimal``, over the messages and
field numbers of ``onnx_minimal.proto`` (a subset of the public ONNX
schema): no ``onnx`` or ``google.protobuf`` package is needed.  Files
written here are standard .onnx protobufs; files read here must use the
ops of the converters' table (the model-zoo CNN family).
"""

from .mx2onnx import export_model, get_model_proto
from .onnx2mx import import_model, import_to_gluon
