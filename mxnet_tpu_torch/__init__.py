"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

The JAX package ``mxnet_tpu`` is the reference; this package follows its
module layout and names, imports ``torch`` and never ``jax`` or
``mxnet_tpu``, and replaces each Pallas TPU kernel with a kernel written
by hand for Hopper (``csrc/``, built at first use by ``_kernels``).
Entry points run on ``cuda:0`` unless the caller passes a CPU device.
"""

from . import base, context, random
from .base import MXNetError
from .context import cpu, gpu, num_gpus
from . import convert, gluon, ops, optimizer, parallel, serving

__all__ = ["MXNetError", "base", "context", "convert", "cpu", "gluon", "gpu",
           "num_gpus", "ops", "optimizer", "parallel", "random", "serving"]
