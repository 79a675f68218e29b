"""Reduction, sorting and argmin/argmax ops on tensors.

Counterpart of ``mxnet_tpu/ops/reduce.py`` (reference:
src/operator/tensor/broadcast_reduce_op_value.cc, ordering_op.cc).
Result dtypes follow the JAX ops under its default 32-bit mode: an
integer sum or product keeps its input's integer type (torch would widen
it to int64), a mean of integers is float32, and index outputs
(``argmax``, ``topk``, ``argsort``) are float32 unless ``dtype`` says
otherwise.  Sorts are stable, as ``jnp.sort``.
"""

from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _norm_axis(axis):
    if axis is None or axis == ():
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _int_result(data, out):
    """The dtype a 32-bit-mode JAX reduction of ``data`` returns."""
    if data.dtype == torch.bool:
        return out.to(torch.int32)
    if not data.is_floating_point():
        return out.to(data.dtype)
    return out


def _dims(data, axis):
    if axis is None:
        return tuple(range(data.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _sum(data, axis, keepdims):
    return _int_result(data, torch.sum(data, dim=_dims(data, axis),
                                       keepdim=keepdims))


def _mean(data, axis, keepdims):
    if not data.is_floating_point():
        data = data.to(torch.float32)
    return torch.mean(data, dim=_dims(data, axis), keepdim=keepdims)


def _prod(data, axis, keepdims):
    out = data
    for d in sorted((a % data.dim() for a in _dims(data, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return _int_result(data, out)


def _max(data, axis, keepdims):
    return torch.amax(data, dim=_dims(data, axis), keepdim=keepdims)


def _min(data, axis, keepdims):
    return torch.amin(data, dim=_dims(data, axis), keepdim=keepdims)


def _nansum(data, axis, keepdims):
    return _int_result(data, torch.nansum(data, dim=_dims(data, axis),
                                          keepdim=keepdims))


def _nanprod(data, axis, keepdims):
    if data.is_floating_point():
        data = torch.where(torch.isnan(data), torch.ones_like(data), data)
    return _prod(data, axis, keepdims)


def _reduce(f):
    def impl(data, axis=None, keepdims=False, exclude=False):
        axis = _norm_axis(axis)
        if exclude and axis is not None:
            ax = axis if isinstance(axis, tuple) else (axis,)
            ax = tuple(a % data.dim() for a in ax)
            axis = tuple(i for i in range(data.dim()) if i not in ax)
        return f(data, axis, keepdims)

    return impl


register("sum", aliases=("sum_axis",))(_reduce(_sum))
register("mean")(_reduce(_mean))
register("prod")(_reduce(_prod))
register("max", aliases=("max_axis",))(_reduce(_max))
register("min", aliases=("min_axis",))(_reduce(_min))
register("nansum")(_reduce(_nansum))
register("nanprod")(_reduce(_nanprod))


def _arg(f, data, axis, keepdims):
    if axis is None:
        out = f(data.reshape(-1))
        return out.reshape((1,) * data.dim()) if keepdims else out
    return f(data, dim=axis, keepdim=keepdims)


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    # reference returns float indices
    return _arg(torch.argmax, data, axis, keepdims).to(torch.float32)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims).to(torch.float32)


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    dims = _dims(data, _norm_axis(axis))
    if ord == 1:
        return torch.sum(torch.abs(data), dim=dims, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=dims,
                                keepdim=keepdims))


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, data.dim()))
    n = torch.sqrt(torch.sum(torch.square(data), dim=axes, keepdim=True)
                   + eps)
    return data / n


@register("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    x = torch.movedim(data, axis, -1)
    vals, idx = torch.topk(x, k, dim=-1, largest=not is_ascend, sorted=True)
    vals = torch.movedim(vals, -1, axis)
    fidx = torch.movedim(idx, -1, axis).to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, fidx
    if ret_typ == "mask":
        # 1 at the top-k positions, 0 elsewhere (reference: ordering_op
        # ret_typ=mask)
        mask = torch.zeros_like(x).scatter(-1, idx, 1)
        return torch.movedim(mask, -1, axis)
    return fidx


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(torch_dtype(dtype))


def _scan(f, a, axis, dtype):
    if axis is None:
        a, axis = a.reshape(-1), 0
    if dtype is not None:
        return f(a.to(torch_dtype(dtype)), dim=axis)
    return _int_result(a, f(a, dim=axis))


@register("cumsum")
def cumsum(a, axis=None, dtype=None):
    return _scan(torch.cumsum, a, axis, dtype)


@register("cumprod")
def cumprod(a, axis=None, dtype=None):
    return _scan(torch.cumprod, a, axis, dtype)
