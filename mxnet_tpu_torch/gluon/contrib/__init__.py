"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``): LoRA
adapters and the contrib data utilities (``IntervalSampler``,
``CharTokenDataset``).  The other contrib families are not ported yet."""

from . import data, lora
from .lora import LoRADense, apply_lora, freeze_for_lora
