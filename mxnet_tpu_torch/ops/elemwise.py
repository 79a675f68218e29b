"""Elementwise unary and binary ops on tensors.

Counterpart of ``mxnet_tpu/ops/elemwise.py`` (reference:
src/operator/tensor/elemwise_unary_op_basic.cc, elemwise_binary_op_basic.cc,
mshadow_op.h).  Result dtypes follow the JAX ops: comparisons and
``logical_not`` give float32 0/1 masks, ``isnan``/``isinf``/``isfinite``
give bool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import relu as _nn_relu
from .registry import register


def _u(name, f, aliases=()):
    register(name, aliases=aliases)(f)
    return f


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# -- unary ---------------------------------------------------------------------
_u("abs", torch.abs)
_u("sign", torch.sign)
_u("ceil", torch.ceil)
_u("floor", torch.floor)
_u("trunc", torch.trunc)
_u("rint", torch.round)          # half to even, as jnp.rint
_u("fix", torch.trunc)
_u("round", torch.round)         # half to even, as jnp.round
_u("exp", torch.exp)
_u("expm1", torch.expm1)
_u("log", torch.log)
_u("log2", torch.log2)
_u("log10", torch.log10)
_u("log1p", torch.log1p)
_u("sqrt", torch.sqrt)
_u("square", torch.square)
_u("cbrt", _cbrt)
_u("negative", torch.negative)
_u("sin", torch.sin)
_u("cos", torch.cos)
_u("tan", torch.tan)
_u("arcsin", torch.asin)
_u("arccos", torch.acos)
_u("arctan", torch.atan)
_u("sinh", torch.sinh)
_u("cosh", torch.cosh)
_u("tanh", torch.tanh)
_u("arcsinh", torch.asinh)
_u("arccosh", torch.acosh)
_u("arctanh", torch.atanh)
_u("degrees", torch.rad2deg)
_u("radians", torch.deg2rad)
_u("erf", torch.erf)
_u("erfinv", torch.erfinv)
_u("gamma", lambda x: torch.exp(torch.lgamma(x)))
_u("gammaln", torch.lgamma)
_u("logical_not", lambda x: torch.logical_not(x).to(torch.float32))
_u("isnan", torch.isnan)
_u("isinf", torch.isinf)
_u("isfinite", torch.isfinite)


@register("reciprocal")
def reciprocal(data):
    return 1.0 / data


@register("rsqrt")
def rsqrt(data):
    return torch.rsqrt(data)


@register("rcbrt")
def rcbrt(data):
    return 1.0 / _cbrt(data)


@register("relu")
def relu(data):
    """max(x, 0) with the JAX package's gradient at 0, 1/2 (``nn.relu``)."""
    return _nn_relu(data)


@register("sigmoid")
def sigmoid(data):
    return torch.sigmoid(data)


@register("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("softsign")
def softsign(data):
    return data / (1.0 + torch.abs(data))


@register("softrelu")
def softrelu(data):
    return F.softplus(data)


@register("gelu")
def gelu(data, approximate=True):
    return F.gelu(data, approximate="tanh" if approximate else "none")


@register("silu", aliases=("swish",))
def silu(data):
    return F.silu(data)


@register("clip")
def clip(data, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


# -- binary (same-shape "elemwise_*" and broadcasting "broadcast_*") -----------
# torch broadcasts natively, so both families share implementations.  A
# Python scalar operand takes the tensor operand's dtype, as a weakly
# typed scalar does in JAX.

def _as_tensors(lhs, rhs):
    if not isinstance(lhs, torch.Tensor):
        lhs = torch.as_tensor(lhs, device=rhs.device,
                              dtype=rhs.dtype if rhs.is_floating_point()
                              else None)
    if not isinstance(rhs, torch.Tensor):
        rhs = torch.as_tensor(rhs, device=lhs.device,
                              dtype=lhs.dtype if lhs.is_floating_point()
                              else None)
    return lhs, rhs


def _tensor_op(f):
    return lambda lhs, rhs: f(*_as_tensors(lhs, rhs))


def _b(name, f, aliases=()):
    register(name, aliases=aliases)(f)
    return f


_b("elemwise_add", lambda lhs, rhs: lhs + rhs,
   aliases=("broadcast_add", "broadcast_plus", "add"))
_b("elemwise_sub", lambda lhs, rhs: lhs - rhs,
   aliases=("broadcast_sub", "broadcast_minus", "subtract"))
_b("elemwise_mul", lambda lhs, rhs: lhs * rhs,
   aliases=("broadcast_mul", "multiply"))
_b("elemwise_div", lambda lhs, rhs: lhs / rhs,
   aliases=("broadcast_div", "divide"))
_b("broadcast_mod", lambda lhs, rhs: lhs % rhs, aliases=("mod",))
_b("broadcast_power", lambda lhs, rhs: lhs ** rhs, aliases=("power", "pow"))
_b("broadcast_maximum", _tensor_op(torch.maximum), aliases=("maximum",))
_b("broadcast_minimum", _tensor_op(torch.minimum), aliases=("minimum",))
_b("broadcast_hypot", _tensor_op(torch.hypot), aliases=("hypot",))


def _cmp(f):
    return lambda lhs, rhs: f(*_as_tensors(lhs, rhs)).to(torch.float32)


# Comparison ops return float32 0/1 masks, matching the reference
# (src/operator/tensor/elemwise_binary_broadcast_op_logic.cc).
_b("broadcast_equal", _cmp(torch.eq), aliases=("equal",))
_b("broadcast_not_equal", _cmp(torch.ne), aliases=("not_equal",))
_b("broadcast_greater", _cmp(torch.gt), aliases=("greater",))
_b("broadcast_greater_equal", _cmp(torch.ge), aliases=("greater_equal",))
_b("broadcast_lesser", _cmp(torch.lt), aliases=("lesser", "less"))
_b("broadcast_lesser_equal", _cmp(torch.le),
   aliases=("lesser_equal", "less_equal"))
_b("broadcast_logical_and", _cmp(torch.logical_and), aliases=("logical_and",))
_b("broadcast_logical_or", _cmp(torch.logical_or), aliases=("logical_or",))
_b("broadcast_logical_xor", _cmp(torch.logical_xor), aliases=("logical_xor",))


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


@register("digamma")
def digamma(data):
    """Reference: mshadow_op digamma (unary_op_gamma)."""
    return torch.digamma(data)
