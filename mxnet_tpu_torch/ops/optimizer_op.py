"""Optimizer update rules as pure functions on tensors.

Counterpart of the ``*_update_pure`` functions of
``mxnet_tpu/ops/optimizer_op.py`` that ``parallel.trainer._PureOptimizer``
calls: each takes the weight, the gradient and the optimizer states and
returns ``(new_weight, *new_states)`` as new tensors, leaving its inputs
untouched.  Hyper-parameters may be Python numbers or 0-dim tensors.  The
per-op quirks of the reference are kept: Adam adds weight decay before it
clips, AdamW decays by ``eta * wd * w`` with no ``lr`` factor, and the bias
correction of Adam is folded into ``lr`` by the caller.  The NDArray
wrappers with the reference's in-place contract come with the NDArray
slice.
"""

from __future__ import annotations

import torch


def _rescale(grad, rescale_grad, clip_gradient):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = grad.clamp(-clip_gradient, clip_gradient)
    return grad


def sgd_update_pure(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=True):
    grad = _rescale(grad, rescale_grad, clip_gradient)
    return (weight - lr * (grad + wd * weight),)


def sgd_mom_update_pure(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0,
                        lazy_update=True):
    grad = _rescale(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * (grad + wd * weight)
    return weight + mom, mom


def nag_mom_update_pure(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    # mom = momentum*mom + grad + wd*w;  w -= lr*(grad + wd*w + momentum*mom)
    grad = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    mom = momentum * mom + grad
    return weight - lr * (grad + momentum * mom), mom


def adam_update_pure(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                     epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0, lazy_update=True):
    # bias correction is folded into `lr` by the caller; clips AFTER
    # adding weight decay: grad = clip(rescale*grad + wd*weight)
    grad = grad * rescale_grad + wd * weight
    if clip_gradient is not None and clip_gradient >= 0:
        grad = grad.clamp(-clip_gradient, clip_gradient)
    mean = beta1 * mean + (1.0 - beta1) * grad
    var = beta2 * var + (1.0 - beta2) * torch.square(grad)
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


def adamw_update_pure(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                      clip_gradient=-1.0):
    """Decoupled weight decay (reference: contrib adamw_update)."""
    grad = _rescale(grad, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1.0 - beta1) * grad
    var = beta2 * var + (1.0 - beta2) * torch.square(grad)
    return (weight - eta * (lr * mean / (torch.sqrt(var) + epsilon)
                            + wd * weight), mean, var)


def rmsprop_update_pure(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8,
                        wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                        clip_weights=-1.0):
    grad = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    n = (1.0 - gamma1) * torch.square(grad) + gamma1 * n
    weight = weight - lr * grad / torch.sqrt(n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        weight = weight.clamp(-clip_weights, clip_weights)
    return weight, n


def rmspropalex_update_pure(weight, grad, n, g, delta, lr, gamma1=0.95,
                            gamma2=0.9, epsilon=1e-8, wd=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            clip_weights=-1.0):
    """Centered RMSProp (Graves 2013), reference rmspropalex_update."""
    grad = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    n = (1.0 - gamma1) * torch.square(grad) + gamma1 * n
    g = (1.0 - gamma1) * grad + gamma1 * g
    delta = gamma2 * delta - lr * grad / torch.sqrt(
        n - torch.square(g) + epsilon)
    weight = weight + delta
    if clip_weights is not None and clip_weights > 0:
        weight = weight.clamp(-clip_weights, clip_weights)
    return weight, n, g, delta


def adagrad_update_pure(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    grad = _rescale(grad, rescale_grad, clip_gradient)
    history = history + torch.square(grad)
    return (weight - lr * (grad / torch.sqrt(history + epsilon)
                           + wd * weight), history)


def lamb_update_phase1_pure(weight, grad, mean, var, t=1, beta1=0.9,
                            beta2=0.999, epsilon=1e-6, wd=0.0,
                            bias_correction=True, rescale_grad=1.0,
                            clip_gradient=-1.0):
    grad = _rescale(grad, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1.0 - beta1) * grad
    var = beta2 * var + (1.0 - beta2) * torch.square(grad)
    if bias_correction:
        mhat = mean / (1.0 - beta1 ** t)
        vhat = var / (1.0 - beta2 ** t)
    else:
        mhat, vhat = mean, var
    g_new = mhat / (torch.sqrt(vhat) + epsilon) + wd * weight
    return g_new, mean, var


def lamb_update_phase2_pure(weight, g, r1, r2, lr, lower_bound=-1.0,
                            upper_bound=-1.0):
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return (weight - lr * ratio * g,)
