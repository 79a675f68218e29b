"""Gluon: ``Parameter``, ``Block``, the ``nn`` layers, the losses, the
``Trainer`` with its whole-step capture, the utilities, the recurrent
layers and cells (``rnn``), the input path (``data``), LoRA, the contrib
recurrent cells and data utilities (``contrib``) and the model zoo
(counterpart of ``mxnet_tpu/gluon/``)."""

from . import block, loss, nn, parameter, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from . import captured, trainer
from .trainer import Trainer
from . import contrib, data, model_zoo
