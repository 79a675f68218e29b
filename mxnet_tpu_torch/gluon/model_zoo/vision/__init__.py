"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/``):
ResNet V1 and V2, the Vision Transformer and the ``get_model`` factory
over them.  The other families of the JAX package's zoo are not ported
yet."""

from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)
from .vit import *  # noqa: F401,F403
from .vit import vit_base, vit_large, vit_small, vit_tiny

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vit_tiny": vit_tiny, "vit_small": vit_small,
    "vit_base": vit_base, "vit_large": vit_large,
}


def get_model(name, **kwargs):
    """A model by name (reference: vision.get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t"
            + "\n\t".join(sorted(_MODELS)))
    return _MODELS[name](**kwargs)
