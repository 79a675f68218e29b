"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``): LoRA
adapters.  The other contrib families are not ported yet."""

from . import lora
from .lora import LoRADense, apply_lora, freeze_for_lora
