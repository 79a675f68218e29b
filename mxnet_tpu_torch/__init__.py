"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

The JAX package ``mxnet_tpu`` is the reference; this package follows its
module layout and names, imports ``torch`` and never ``jax`` or
``mxnet_tpu``, and replaces each Pallas TPU kernel with a kernel written
by hand for Hopper (``csrc/``, built at first use by ``_kernels``; user
kernels compiled at runtime by ``rtc.CudaModule``).  Entry points run on
``gpu(0)`` unless the caller passes or scopes a CPU context.
"""

# the memory knobs are read before anything can start CUDA (reference
# analog: the pool's environment read at Storage::Get())
from . import storage
storage.apply_env()

from . import base, context, engine, random
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from . import ops
from . import autograd, ndarray, rtc
from . import ndarray as nd
from . import initializer, name
from . import initializer as init
from . import numerics, operator, optimizer
from . import kvstore
from . import kvstore as kv
from . import amp, convert, gluon, metric, parallel, serving
from . import profiler, recordio, resilience, telemetry
from . import callback, embedding, image, io
from . import checkpoint, distributed, integrity, obs
from . import attribute, model, module, monitor, subgraph, symbol
from . import visualization
from . import contrib, runtime, test_utils
from . import module as mod
from . import monitor as mon
from . import symbol as sym
from . import visualization as viz
from .attribute import AttrScope

__all__ = ["AttrScope", "Context", "MXNetError", "amp", "attribute",
           "autograd", "base", "callback", "checkpoint", "context", "contrib",
           "convert", "cpu", "current_context", "distributed", "embedding",
           "engine", "gluon", "gpu", "image", "init", "initializer",
           "integrity", "io", "kv", "kvstore", "metric", "mod", "model",
           "module", "mon", "monitor", "name", "nd", "ndarray", "num_gpus",
           "numerics", "obs", "operator", "ops", "optimizer", "parallel",
           "profiler", "random", "recordio", "resilience", "rtc", "runtime",
           "serving", "storage", "subgraph", "sym", "symbol", "telemetry",
           "test_utils", "visualization", "viz"]
