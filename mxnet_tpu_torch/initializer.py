"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the ``Initializer`` base with
its name-suffix dispatch (``*weight`` and ``*embed_table``, the
``ShardedEmbedding`` table, get the initializer's own rule, ``*bias``
and ``*beta`` zeros, ``*gamma`` ones), the per-parameter
override that a parameter's own ``init`` takes over it (the JAX package's
``InitDesc.attrs["__init__"]``, set by ``Parameter(init=...)``), the
built-ins ``Zero``, ``One``, ``Constant``, ``Uniform``, ``Normal`` and
``Xavier``, and ``create``.  ``initialize`` walks a Gluon ``Block``'s
``collect_params()``.

The JAX package draws from numpy's global RNG; here every draw takes an
explicit ``torch.Generator`` on the parameter's device.  The two never
give the same numbers from one seed, so parity tests carry weights across
(``convert``) and test the initializers by their scales and moments.
"""

from __future__ import annotations

import math

import torch

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from its registered name (``"xavier"``, ``"normal"``,
    ``"zeros"`` ...); an ``Initializer`` is returned as it is."""
    if isinstance(name, Initializer):
        return name
    if name.lower() not in _INIT_REGISTRY:
        raise ValueError(f"Cannot find initializer {name}")
    return _INIT_REGISTRY[name.lower()](**kwargs)


def _fill(arr, draw):
    """Write ``draw(f32 tensor)`` into ``arr`` whatever its dtype: draws
    are made in f32 on ``arr``'s device, then cast."""
    tmp = torch.empty(arr.shape, dtype=torch.float32, device=arr.device)
    draw(tmp)
    with torch.no_grad():
        arr.copy_(tmp)


class Initializer:
    """Base initializer: ``init(name, arr, generator, init=None)`` fills
    ``arr`` in place.  ``init`` is the parameter's own initializer name;
    when given it wins over the suffix dispatch."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, generator=None, init=None):
        if init:
            create(init)._init_weight(name, arr, generator)
        elif name.endswith(("weight", "embed_table")):
            self._init_weight(name, arr, generator)
        elif name.endswith("bias") or name.endswith("beta"):
            _fill(arr, lambda t: t.zero_())
        elif name.endswith("gamma"):
            _fill(arr, lambda t: t.fill_(1.0))
        else:
            raise ValueError(
                f"Unknown initialization pattern for {name}. Default "
                "initialization is limited to \"weight\", \"bias\", "
                "\"gamma\" (1.0), and \"beta\" (0.0); give the parameter "
                "its own init")

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("Must override it")

    def __eq__(self, other):
        if not isinstance(other, Initializer):
            return NotImplemented
        return (self.__class__ is other.__class__
                and self._kwargs == other._kwargs)

    __hash__ = None


@register
class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        _fill(arr, lambda t: t.zero_())


@register
class One(Initializer):
    def _init_weight(self, name, arr, generator):
        _fill(arr, lambda t: t.fill_(1.0))


@register
class Constant(Initializer):
    """Every element ``value`` (a number, or an array broadcast to the
    parameter's shape)."""

    def __init__(self, value):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
        v = torch.as_tensor(getattr(self.value, "_data", self.value),
                            dtype=torch.float32)
        _fill(arr, lambda t: t.copy_(v.to(t.device).expand_as(t)))


# the JAX package's alias names
_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    """U(-scale, scale) (default scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        _fill(arr, lambda t: t.uniform_(-self.scale, self.scale,
                                        generator=generator))


@register
class Normal(Initializer):
    """N(0, sigma) (default sigma 0.01)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        _fill(arr, lambda t: t.normal_(0.0, self.sigma, generator=generator))


@register
class Xavier(Initializer):
    """Xavier/Glorot: U(-s, s) or N(0, s) with s = sqrt(magnitude /
    factor).  ``factor_type`` "avg", "in" or "out" picks the factor from
    fan_in = shape[1] * prod(shape[2:]) and fan_out = shape[0] *
    prod(shape[2:]), the JAX package's fans for any rank: a stacked
    (L, 3u, u) trunk weight counts L as its fan-out and takes a small
    scale, as there."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, name, shape):
        """The bound (uniform) or sigma (gaussian) for a weight of
        ``shape``."""
        if len(shape) < 2:
            raise ValueError(
                f"Xavier initializer cannot be applied to vector {name}. "
                "It requires at least 2D.")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr, generator):
        s = self.scale(name, tuple(arr.shape))
        if self.rnd_type == "uniform":
            _fill(arr, lambda t: t.uniform_(-s, s, generator=generator))
        elif self.rnd_type == "gaussian":
            _fill(arr, lambda t: t.normal_(0.0, s, generator=generator))
        else:
            raise ValueError("Unknown random type")


def initialize(block, init="uniform", inits_by_name=None, generator=None):
    """Fill every parameter of a Gluon ``block`` in place, through its
    ``collect_params()``, by Gluon name: the one named in
    ``inits_by_name`` (``{parameter name: init name}``) by its own init,
    every other by its own ``init`` or ``init``'s suffix dispatch (the JAX
    package's default global init is ``"uniform"``), the ``grad_req=
    "null"`` parameters too (BatchNorm's running statistics take their
    own ``zeros``/``ones``).  Draws come from ``generator``, default the
    next generator of the package chain on each parameter's device
    (``random.seed`` makes them reproducible); a deferred parameter draws
    when its shape is known."""
    init = create(init)
    inits_by_name = dict(inits_by_name or {})
    params = block.collect_params()
    unknown = sorted(set(inits_by_name) - set(params.keys()))
    if unknown:
        raise ValueError(f"initialize: no parameter named {unknown}")
    for name, p in params.items():
        ctx = p._ctx or (p._deferred_init[2] if p._deferred_init else None)
        p.initialize(inits_by_name.get(name), ctx, init, force_reinit=True,
                     generator=generator)
