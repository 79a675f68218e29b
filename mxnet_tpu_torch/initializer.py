"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the ``Initializer`` base with
its name-suffix dispatch (``*weight`` and ``*embed_table``, the
``ShardedEmbedding`` table, get the initializer's own rule, ``*bias``
and ``*beta`` zeros, ``*gamma`` ones), the per-parameter
override that a parameter's own ``init`` takes over it (the JAX package's
``InitDesc.attrs["__init__"]``, set by ``Parameter(init=...)``; an
``InitDesc`` name carries it too), ``dumps``, the built-ins ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Xavier``,
``MSRAPrelu``, ``Orthogonal``, ``Bilinear``, ``LSTMBias`` and
``FusedRNN`` (the packed vector of the fused RNN op), the dispatchers
``Mixed`` and ``Load``, and ``create``.  ``initialize`` walks a Gluon
``Block``'s ``collect_params()``.

The JAX package draws from numpy's global RNG; here every draw takes an
explicit ``torch.Generator`` on the parameter's device.  The two never
give the same numbers from one seed, so parity tests carry weights across
(``convert``) and test the initializers by their scales and moments.
"""

from __future__ import annotations

import json
import logging
import math
import re

import torch

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from its registered name (``"xavier"``, ``"normal"``,
    ``"zeros"`` ...); an ``Initializer`` (or another callable such as
    ``Mixed`` or ``Load``) is returned as it is."""
    if not isinstance(name, str):
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


class InitDesc(str):
    """A parameter's name with its attributes (``attrs["__init__"]``, the
    parameter's own initializer) and the global initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: ``init(name, arr, generator, init=None)`` fills
    ``arr`` in place.  ``init`` is the parameter's own initializer (a name
    or an ``Initializer``); when given, or carried by an ``InitDesc``
    name, it wins over the suffix dispatch."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON; ``create(name, **kwargs)`` makes
        the initializer again."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr, generator=None, init=None):
        if not init and isinstance(name, InitDesc):
            if name.global_init is None:
                name.global_init = self
            init = name.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(name, arr, generator)
        elif name.endswith(("weight", "embed_table")):
            self._init_weight(name, arr, generator)
        elif name.endswith("bias"):
            self._init_bias(name, arr, generator)
        elif name.endswith("beta"):
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

    def _init_bias(self, name, arr, generator):
        _fill(arr, lambda t: t.zero_())

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


@register
class MSRAPrelu(Xavier):
    """He/MSRA initialisation for PReLU nets: Gaussian Xavier with
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """An orthogonal matrix (Saxe et al.) times ``scale``: the factor of
    the SVD of a (out, prod(in)) draw, U(-1, 1) or N(0, 1) by
    ``rand_type``, whose shape is the weight's."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _s, q = torch.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else q
        _fill(arr, lambda t: t.copy_(self.scale * res.reshape(t.shape)))


def _bilinear(shape):
    """The bilinear upsampling kernel of a 4-D (out, in, kh, kw) weight."""
    f = math.ceil(shape[3] / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    x = torch.arange(shape[3], dtype=torch.float64)
    y = torch.arange(shape[2], dtype=torch.float64)
    k = (1 - (y[:, None] / f - c).abs()) * (1 - (x[None, :] / f - c).abs())
    return k.to(torch.float32).expand(shape)


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a Deconvolution weight)."""

    def _init_weight(self, name, arr, generator):
        k = _bilinear(tuple(arr.shape))
        _fill(arr, lambda t: t.copy_(k.to(t.device)))


@register
class LSTMBias(Initializer):
    """Zeros, except the forget gate's quarter [H, 2H) of an LSTM bias
    (gates i f g o), which gets ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        h = arr.shape[0] // 4

        def draw(t):
            t.zero_()
            t[h:2 * h] = self.forget_bias
        _fill(arr, draw)

    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The fused RNN op's packed parameter vector: the wrapped ``init``
    fills it whole, then, for an LSTM, each layer and direction's
    forget-gate slice of ``bx`` gets ``forget_bias`` and that of ``bh``
    zero (the packing of ``ops/rnn.py``: every weight, then every
    (bx, bh) pair)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        if self._init is not None:
            self._init._init_weight(name, arr, generator)
        if self._mode != "lstm":
            return
        h = self._num_hidden
        dirs = 2 if self._bidirectional else 1
        gates = 4
        off = arr.numel() - self._num_layers * dirs * 2 * gates * h
        flat = arr.view(-1)
        with torch.no_grad():
            for _ in range(self._num_layers * dirs):
                flat[off + h:off + 2 * h] = self._forget_bias  # bx forget
                off += gates * h
                flat[off + h:off + 2 * h] = 0.0                # bh forget
                off += gates * h


class Mixed:
    """Dispatch by name: the initializer of the first pattern (a regex,
    matched at the name's start) that matches."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator=None, init=None):
        for prog, ini in self.map:
            if prog.match(name):
                ini(name, arr, generator, init)
                return
        raise ValueError(
            f"Parameter name {name} did not match any pattern. Consider "
            "adding a \".*\" pattern at the and with default Initializer.")


@register
class Load:
    """Initialise from a dict of arrays (NDArrays, tensors or numpy; or
    the path of an ``nd.save`` file), names with an ``arg:``/``aux:``
    prefix stripped; a name not in it falls to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .context import cpu
            from .ndarray import load as nd_load

            param = nd_load(param, ctx=cpu())
        self.param = {}
        for name, arr in param.items():
            key = name[4:] if name.startswith(("arg:", "aux:")) else name
            self.param[key] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None, init=None):
        if name in self.param:
            src = self.param[name]
            src = torch.as_tensor(getattr(src, "_data", src))
            if tuple(arr.shape) != tuple(src.shape):
                raise ValueError(
                    f"Parameter {name} cannot be initialized from loading. "
                    f"Shape mismatch, target {tuple(arr.shape)} vs loaded "
                    f"{tuple(src.shape)}")
            with torch.no_grad():
                arr.copy_(src.to(arr.device))
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    f"Cannot Initialize parameter: {name}. Not found in "
                    "loaded param and no default Initializer is provided.")
            self.default_init(name, arr, generator, init)
            if self.verbose:
                logging.info("Initialized %s by default", name)


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
