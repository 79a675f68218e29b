"""Optimizers (counterpart of ``mxnet_tpu/optimizer/``): the registered
``Optimizer`` classes, ``Updater``/``get_updater``, the learning-rate
schedulers and the multi-tensor ``GroupedUpdater``."""

from . import lr_scheduler, optimizer
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)
from .optimizer import (DCASGD, FTML, LAMB, LARS, LBSGD, NAG, SGD, SGLD,
                        AdaDelta, AdaGrad, Adam, Adamax, AdamW, Ftrl, Nadam,
                        Optimizer, RMSProp, Signum, Test, Updater, create,
                        get_updater, register)
from . import grouped
from .grouped import GroupedUpdater

__all__ = ["AdaDelta", "AdaGrad", "Adam", "AdamW", "Adamax",
           "CosineScheduler", "DCASGD", "FTML", "FactorScheduler", "Ftrl",
           "GroupedUpdater", "LAMB", "LARS", "LBSGD", "LRScheduler",
           "MultiFactorScheduler", "NAG", "Nadam", "Optimizer",
           "PolyScheduler", "RMSProp", "SGD", "SGLD", "Signum", "Test",
           "Updater", "create", "get_updater", "grouped", "lr_scheduler",
           "optimizer", "register"]
