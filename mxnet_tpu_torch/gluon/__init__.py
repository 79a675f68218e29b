"""Gluon: ``Parameter``, ``Block``, the ``nn`` layers, the losses and the
model zoo (counterpart of ``mxnet_tpu/gluon/``)."""

from . import block, loss, nn, parameter
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from . import model_zoo
