"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``): LoRA
adapters, the contrib data utilities (``IntervalSampler``,
``CharTokenDataset``) and the contrib recurrent cells (``rnn``:
``VariationalDropoutCell``, ``Conv2DLSTMCell``).  The other contrib
families are not ported yet."""

from . import data, lora, rnn
from .lora import LoRADense, apply_lora, freeze_for_lora
