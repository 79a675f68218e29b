"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``): the
contrib layers (``nn``: ``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SparseEmbedding``, ``SyncBatchNorm``, ``PixelShuffle*``),
the deformable convolution layer (``cnn``), the ``Estimator`` fit loop,
LoRA adapters, the contrib data utilities (``IntervalSampler``,
``CharTokenDataset``) and the contrib recurrent cells (``rnn``:
``VariationalDropoutCell``, ``Conv2DLSTMCell``) and the sparse MoE FFN
(``moe``: ``MoEFFN``)."""

from . import cnn, data, estimator, lora, moe, nn, rnn
from .estimator import Estimator
from .lora import LoRADense, apply_lora, freeze_for_lora
from .moe import MoEFFN
