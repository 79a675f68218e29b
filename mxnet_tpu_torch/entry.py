"""The port's counterpart of ``__graft_entry__.entry()``: a ResNet-50 v1
forward and an example input."""

from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from .context import current_context
from .gluon.model_zoo import vision
from .initializer import Xavier


def entry():
    """Return ``(fn, (example,))``: ``fn`` is a ResNet-50 v1 forward
    (1000 classes, Xavier weights, f32, predict mode) on
    ``current_context()`` (the card unless a ``with cpu():`` scope is
    open), ``example`` an (8, 3, 224, 224) f32 batch from
    ``RandomState(0)`` there."""
    ctx = current_context()
    net = vision.resnet50_v1(classes=1000)
    net.initialize(init=Xavier(), ctx=ctx)
    # the deferred channel shapes do not depend on the spatial size
    net(nd.zeros((1, 3, 32, 32), ctx=ctx))

    def fn(x):
        return net(x)

    example = torch.as_tensor(
        np.random.RandomState(0).standard_normal((8, 3, 224, 224))
        .astype("float32"), device=ctx.device)
    return fn, (example,)
