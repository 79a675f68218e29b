"""``mx.contrib``: int8 quantization and ONNX interchange.

Counterpart of ``mxnet_tpu/contrib/__init__.py`` (reference:
python/mxnet/contrib/); ``contrib.amp`` is the package's ``amp``, as
``mx.contrib.amp`` is ``mx.amp`` in the reference.
"""

from . import onnx, quantization
from .. import amp  # noqa: F401  (reference path: mx.contrib.amp)
