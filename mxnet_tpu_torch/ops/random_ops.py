"""Random sampling ops, drawing from explicit ``torch.Generator``s.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (reference:
src/operator/random/sample_op.cc, multisample_op.cc, shuffle_op.cc).  The
wrapper injects ``_key``, a generator from the package's chain
(``mx.random.seed``), on the device the draw lands on.  The JAX package
draws with threefry and torch with Philox, so the two give other numbers
from one seed: the tests hold seed determinism inside the port, shapes,
dtypes, and moments against the distribution.  Gamma draws use
Marsaglia and Tsang's method on the generator (``torch._standard_gamma``
takes none).
"""

from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _rand(shape, g, dtype=torch.float32):
    return torch.rand(shape, generator=g, device=g.device, dtype=dtype)


def _randn(shape, g, dtype=torch.float32):
    return torch.randn(shape, generator=g, device=g.device, dtype=dtype)


def _standard_gamma(alpha, shape, g):
    """Gamma(alpha, 1) draws of ``shape`` (alpha a float or a tensor that
    broadcasts to it): Marsaglia and Tsang, boosted by U^(1/alpha) for
    alpha < 1."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=g.device).expand(shape)
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(shape, device=g.device)
    todo = torch.ones(shape, dtype=torch.bool, device=g.device)
    while bool(todo.any()):
        x = _randn(shape, g)
        v = (1 + c * x) ** 3
        u = _rand(shape, g)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d
                        - d * v + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = _rand(shape, g)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


@register("random_uniform", aliases=("uniform",), random=True)
def random_uniform(low=0.0, high=1.0, shape=None, dtype="float32", _key=None):
    return low + (high - low) * _rand(_shape(shape), _key, torch_dtype(dtype))


@register("random_normal", aliases=("normal",), random=True)
def random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32", _key=None):
    return loc + scale * _randn(_shape(shape), _key, torch_dtype(dtype))


@register("random_gamma", aliases=("gamma_sample",), random=True)
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", _key=None):
    return (beta * _standard_gamma(alpha, _shape(shape), _key)).to(
        torch_dtype(dtype))


@register("random_exponential", aliases=("exponential",), random=True)
def random_exponential(lam=1.0, shape=None, dtype="float32", _key=None):
    e = torch.empty(_shape(shape), device=_key.device).exponential_(
        generator=_key)
    return (e / lam).to(torch_dtype(dtype))


@register("random_poisson", aliases=("poisson",), random=True)
def random_poisson(lam=1.0, shape=None, dtype="float32", _key=None):
    rates = torch.full(_shape(shape), float(lam), device=_key.device)
    return torch.poisson(rates, generator=_key).to(torch_dtype(dtype))


def _gamma_poisson(r, p, shape, g, dtype):
    lam = _standard_gamma(r, shape, g) * (1 - p) / p
    return torch.poisson(lam, generator=g).to(torch_dtype(dtype))


@register("random_negative_binomial", aliases=("negative_binomial",),
          random=True)
def random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                             _key=None):
    return _gamma_poisson(k, p, _shape(shape), _key, dtype)


@register("random_generalized_negative_binomial",
          aliases=("generalized_negative_binomial",), random=True)
def random_gnb(mu=1.0, alpha=1.0, shape=None, dtype="float32", _key=None):
    r = 1.0 / alpha
    return _gamma_poisson(r, r / (r + mu), _shape(shape), _key, dtype)


@register("random_randint", aliases=("randint",), random=True)
def random_randint(low=0, high=1, shape=None, dtype="int32", _key=None):
    return torch.randint(int(low), int(high), _shape(shape), generator=_key,
                         device=_key.device, dtype=torch_dtype(dtype))


@register("sample_multinomial", aliases=("multinomial",), random=True)
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       _key=None):
    n = _shape(shape)
    num = 1
    for s in n:
        num *= s
    probs = data.reshape(-1, data.shape[-1]).clamp_min(1e-30)
    out = torch.multinomial(probs, num, replacement=True, generator=_key)
    lead = (data.shape[0],) if data.dim() > 1 else ()
    idx = out.reshape(lead + n)
    if get_prob:
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        lp = torch.gather(logp, -1, out).reshape(idx.shape)
        return idx.to(torch_dtype(dtype)), lp
    return idx.to(torch_dtype(dtype))


@register("sample_uniform", random=True)
def sample_uniform(low, high, shape=None, dtype="float32", _key=None):
    s = _shape(shape)
    u = _rand(low.shape + s, _key, torch_dtype(dtype))
    low_b = low.reshape(low.shape + (1,) * len(s))
    high_b = high.reshape(high.shape + (1,) * len(s))
    return low_b + u * (high_b - low_b)


@register("sample_normal", random=True)
def sample_normal(mu, sigma, shape=None, dtype="float32", _key=None):
    s = _shape(shape)
    z = _randn(mu.shape + s, _key, torch_dtype(dtype))
    return mu.reshape(mu.shape + (1,) * len(s)) + \
        sigma.reshape(sigma.shape + (1,) * len(s)) * z


@register("shuffle", aliases=("random_shuffle",), random=True)
def shuffle(data, _key=None):
    return data[torch.randperm(data.shape[0], generator=_key,
                               device=_key.device)]


@register("random_bernoulli", aliases=("bernoulli",), random=True)
def random_bernoulli(p=0.5, shape=None, dtype="float32", _key=None):
    return (_rand(_shape(shape), _key) < p).to(torch_dtype(dtype))
