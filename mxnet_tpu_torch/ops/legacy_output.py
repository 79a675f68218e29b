"""Legacy output and loss-head ops.

Counterpart of ``mxnet_tpu/ops/legacy_output.py`` (reference:
src/operator/regression_output.cc, svm_output.cc, make_loss.cc and
contrib/all_finite.cc).  The heads' forward is (nearly) the identity and
their backward injects the loss's gradient, ignoring the incoming head
gradient, as the reference's explicit backward kernels do: each is a
``torch.autograd.Function`` with that asymmetry, as ``_SoftmaxOutput``
in ``ops/nn.py`` is.  The label's gradient is zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


class _Head(torch.autograd.Function):
    """forward = ``fwd(data)``; d(data) = ``grad(data, label) *
    grad_scale / batch`` in data's dtype."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, fwd, grad):
        ctx.save_for_backward(data, label)
        ctx.cfg = (grad_scale, grad)
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        grad_scale, grad = ctx.cfg
        scale = grad_scale / data.shape[0]
        dd = (grad(data, label.reshape(data.shape)) * scale).to(data.dtype)
        return dd, torch.zeros_like(label), None, None, None


def _identity(d):
    return d.clone()


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity forward; the backward injects (pred - label)."""
    return _Head.apply(data, label, float(grad_scale), _identity,
                       lambda d, l: d - l)


@register("MAERegressionOutput", aliases=("mae_regression_output",))
def mae_regression_output(data, label, grad_scale=1.0):
    return _Head.apply(data, label, float(grad_scale), _identity,
                       lambda d, l: torch.sign(d - l))


@register("LogisticRegressionOutput",
          aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale=1.0):
    return _Head.apply(data, label, float(grad_scale), torch.sigmoid,
                       lambda d, l: torch.sigmoid(d) - l)


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, linear = ctx.cfg
        onehot = F.one_hot(label.long(), data.shape[1]).to(data.dtype)
        score_y = (data * onehot).sum(dim=1, keepdim=True)
        viol = margin - (score_y - data)          # margin violation
        active = (viol > 0) & (onehot == 0)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if linear:
            dwrong = torch.where(active, torch.full_like(data, reg), zero)
        else:
            dwrong = torch.where(active, 2.0 * viol * reg, zero)
        dright = -dwrong.sum(dim=1, keepdim=True) * onehot
        return ((dwrong + dright).to(data.dtype), torch.zeros_like(label),
                None, None, None)


@register("SVMOutput", aliases=("svm_output",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity forward; the backward is the (squared) hinge loss's
    gradient."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scale, norm, thresh):
        if norm == "valid":
            # only 'valid' needs the values in the backward
            ctx.save_for_backward(data)
        ctx.cfg = (scale, norm, thresh, tuple(data.shape), data.dtype)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        scale, norm, thresh, shape, dtype = ctx.cfg
        if norm == "valid":
            (data,) = ctx.saved_tensors
            denom = torch.clamp((data > thresh).sum().to(torch.float32),
                                min=1.0)
        else:
            denom = torch.tensor(float(shape[0]) if norm == "batch" else 1.0,
                                 dtype=torch.float32, device=g.device)
        # divide in f32: a f16 denominator overflows past 65504 elements
        grad = (scale / denom).expand(shape).to(dtype)
        return grad.contiguous(), None, None, None


@register("MakeLoss", aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0,
              normalization="null"):
    """Marks a loss terminal: identity forward, and d(data) =
    ``grad_scale`` normalised by ``normalization``: 'null' none, 'batch'
    the batch size, 'valid' the count of elements of the data above
    ``valid_thresh`` (at least 1)."""
    if normalization not in ("null", "batch", "valid"):
        raise ValueError(f"MakeLoss: unknown normalization "
                         f"{normalization!r}")
    return _MakeLoss.apply(data, float(grad_scale), normalization,
                           float(valid_thresh))


@register("all_finite")
def all_finite(data, init_output=True):
    """1.0 if every element is finite (the AMP overflow check)."""
    return torch.isfinite(data).all().to(torch.float32)


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32)
