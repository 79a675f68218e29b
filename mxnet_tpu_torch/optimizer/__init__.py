"""Optimizers: the learning-rate schedulers (the update rules the trainer
applies are ``ops.optimizer_op``'s)."""

from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)

__all__ = ["CosineScheduler", "FactorScheduler", "LRScheduler",
           "MultiFactorScheduler", "PolyScheduler", "lr_scheduler"]
