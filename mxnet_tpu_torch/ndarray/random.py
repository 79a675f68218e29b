"""mx.nd.random: the sampling namespace (counterpart of
``mxnet_tpu/ndarray/random.py``)."""

from __future__ import annotations

from ..ops import registry as _registry
from . import register as _register


def _alias(public, opname):
    opdef = _registry.get(opname)

    def f(*args, **kwargs):
        return _register.invoke(opdef, args, kwargs)

    f.__name__ = public
    return f


uniform = _alias("uniform", "random_uniform")
normal = _alias("normal", "random_normal")


def randn(*shape, **kwargs):
    return normal(shape=shape, **kwargs)


gamma = _alias("gamma", "random_gamma")
exponential = _alias("exponential", "random_exponential")
poisson = _alias("poisson", "random_poisson")
negative_binomial = _alias("negative_binomial", "random_negative_binomial")
generalized_negative_binomial = _alias(
    "generalized_negative_binomial", "random_generalized_negative_binomial")
randint = _alias("randint", "random_randint")
multinomial = _alias("multinomial", "sample_multinomial")
shuffle = _alias("shuffle", "shuffle")
bernoulli = _alias("bernoulli", "random_bernoulli")
