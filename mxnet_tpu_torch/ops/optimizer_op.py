"""Optimizer update rules, the registered NDArray update ops and the
single-parameter dispatch.

Counterpart of ``mxnet_tpu/ops/optimizer_op.py`` (reference:
src/operator/optimizer_op.cc).  Each rule is written once, over an
arithmetic namespace ``F``:

- ``TENSOR`` runs it on one tensor (the ``*_update_pure`` functions, the
  registered ``mx.nd.*_update`` ops and the per-parameter ``Updater``);
- ``optimizer.grouped.LISTS`` runs the same lines over a group of tensors
  as ``torch._foreach_*`` chains (the ``GroupedUpdater`` and the captured
  step).

So the grouped update does the same arithmetic in the same order as the
single-tensor one, op for op.  A pure rule takes the weight, the gradient
and the states and returns ``(new_weight, *new_states)`` as new tensors,
leaving its inputs untouched.  Hyper-parameters are Python numbers, 0-dim
tensors or, in a group, ``grouped.Col`` columns.  The per-op quirks of the
reference are kept: Adam and FTML add weight decay before they clip,
AdamW decays by ``eta * wd * w`` with no ``lr`` factor, FTML names its clip
``clip_grad``, and Adam's bias correction is folded into ``lr`` by the
caller.

``fused_dispatch`` is the per-parameter path's entry: the per-step scalars
(``lr``, ``wd``, ``rescale_grad``, the step-count coefficients) enter as
0-dim tensors of the weight's dtype, as the reference casts them, so the
per-parameter and grouped paths round them alike.
"""

from __future__ import annotations

import operator

import torch

from .registry import register


class _TensorOps:
    """The rules' arithmetic on single tensors (and 0-dim scalars)."""

    mul = staticmethod(operator.mul)
    add = staticmethod(operator.add)
    sub = staticmethod(operator.sub)
    div = staticmethod(operator.truediv)
    sqrt = staticmethod(torch.sqrt)
    sign = staticmethod(torch.sign)
    abs = staticmethod(torch.abs)
    neg = staticmethod(torch.neg)

    @staticmethod
    def square(x):
        return x * x

    @staticmethod
    def clamp_min(x, lo):
        return torch.clamp_min(x, lo)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp_max(torch.clamp_min(x, lo), hi)

    @staticmethod
    def norm(x):
        return torch.linalg.vector_norm(x)

    @staticmethod
    def scalar_max(r, c):
        return torch.clamp_min(r, c)

    @staticmethod
    def scalar_min(r, c):
        return torch.clamp_max(r, c)

    @staticmethod
    def trust(r1, r2, ratio):
        """``ratio`` where both norms are positive, else 1."""
        return torch.where((r1 > 0) & (r2 > 0), ratio,
                           torch.ones_like(ratio))


TENSOR = _TensorOps()


def _clipped(F, grad, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        grad = F.clip(grad, -clip_gradient, clip_gradient)
    return grad


def _rescale(F, grad, rescale_grad, clip_gradient):
    return _clipped(F, F.mul(grad, rescale_grad), clip_gradient)


def _decayed(F, grad, weight, wd):
    """``grad + wd * weight``."""
    return F.add(grad, F.mul(weight, wd))


def _ema(F, state, beta, x):
    """``beta * state + (1 - beta) * x``."""
    return F.add(F.mul(state, beta), F.mul(x, 1.0 - beta))


# -- the rules, over F ---------------------------------------------------------

def sgd_rule(F, weight, grad, lr, wd=0.0, rescale_grad=1.0,
             clip_gradient=-1.0, lazy_update=True):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    return (F.sub(weight, F.mul(_decayed(F, grad, weight, wd), lr)),)


def sgd_mom_rule(F, weight, grad, mom, lr, momentum=0.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    mom = F.sub(F.mul(mom, momentum),
                F.mul(_decayed(F, grad, weight, wd), lr))
    return F.add(weight, mom), mom


def nag_mom_rule(F, weight, grad, mom, lr, momentum=0.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    # mom = momentum*mom + grad + wd*w;  w -= lr*(grad + wd*w + momentum*mom)
    grad = _decayed(F, _rescale(F, grad, rescale_grad, clip_gradient),
                    weight, wd)
    mom = F.add(F.mul(mom, momentum), grad)
    return F.sub(weight, F.mul(F.add(grad, F.mul(mom, momentum)), lr)), mom


def _adam_moments(F, grad, mean, var, beta1, beta2):
    return _ema(F, mean, beta1, grad), _ema(F, var, beta2, F.square(grad))


def adam_rule(F, weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
              epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
              lazy_update=True):
    # clips AFTER adding weight decay: grad = clip(rescale*grad + wd*weight)
    grad = _clipped(F, _decayed(F, F.mul(grad, rescale_grad), weight, wd),
                    clip_gradient)
    mean, var = _adam_moments(F, grad, mean, var, beta1, beta2)
    step = F.div(F.mul(mean, lr), F.add(F.sqrt(var), epsilon))
    return F.sub(weight, step), mean, var


def adamw_rule(F, weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
               epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """Decoupled weight decay (reference: contrib adamw_update)."""
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    mean, var = _adam_moments(F, grad, mean, var, beta1, beta2)
    step = F.add(F.div(F.mul(mean, lr), F.add(F.sqrt(var), epsilon)),
                 F.mul(weight, wd))
    return F.sub(weight, F.mul(step, eta)), mean, var


def _clip_weights(F, weight, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        weight = F.clip(weight, -clip_weights, clip_weights)
    return weight


def rmsprop_rule(F, weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    grad = _decayed(F, _rescale(F, grad, rescale_grad, clip_gradient),
                    weight, wd)
    n = F.add(F.mul(F.square(grad), 1.0 - gamma1), F.mul(n, gamma1))
    weight = F.sub(weight, F.div(F.mul(grad, lr),
                                 F.sqrt(F.add(n, epsilon))))
    return _clip_weights(F, weight, clip_weights), n


def rmspropalex_rule(F, weight, grad, n, g, delta, lr, gamma1=0.95,
                     gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013), reference rmspropalex_update."""
    grad = _decayed(F, _rescale(F, grad, rescale_grad, clip_gradient),
                    weight, wd)
    n = F.add(F.mul(F.square(grad), 1.0 - gamma1), F.mul(n, gamma1))
    g = F.add(F.mul(grad, 1.0 - gamma1), F.mul(g, gamma1))
    delta = F.sub(F.mul(delta, gamma2), F.div(
        F.mul(grad, lr), F.sqrt(F.add(F.sub(n, F.square(g)), epsilon))))
    weight = F.add(weight, delta)
    return _clip_weights(F, weight, clip_weights), n, g, delta


def ftrl_rule(F, weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
              rescale_grad=1.0, clip_gradient=-1.0):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    new_n = F.add(n, F.square(grad))
    sigma = F.div(F.sub(F.sqrt(new_n), F.sqrt(n)), lr)
    z = F.sub(F.add(z, grad), F.mul(sigma, weight))
    shrunk = F.mul(F.neg(F.sign(z)), F.clamp_min(F.sub(F.abs(z), lamda1),
                                                 0.0))
    denom = F.add(F.div(F.add(F.sqrt(new_n), beta), lr), wd)
    return F.div(shrunk, denom), z, new_n


def signsgd_rule(F, weight, grad, lr, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    return (F.sub(weight, F.mul(_decayed(F, F.sign(grad), weight, wd), lr)),)


def signum_rule(F, weight, grad, mom, lr, momentum=0.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    mom = F.sub(F.mul(mom, momentum),
                F.mul(_decayed(F, grad, weight, wd), 1.0 - momentum))
    weight = F.add(F.mul(weight, 1.0 - lr * wd_lh), F.mul(F.sign(mom), lr))
    return weight, mom


def adagrad_rule(F, weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    history = F.add(history, F.square(grad))
    step = F.add(F.div(grad, F.sqrt(F.add(history, epsilon))),
                 F.mul(weight, wd))
    return F.sub(weight, F.mul(step, lr)), history


def adadelta_rule(F, weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                  wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    grad = _decayed(F, _rescale(F, grad, rescale_grad, clip_gradient),
                    weight, wd)
    acc_g = _ema(F, acc_g, rho, F.square(grad))
    delta = F.mul(F.div(F.sqrt(F.add(acc_delta, epsilon)),
                        F.sqrt(F.add(acc_g, epsilon))), grad)
    acc_delta = _ema(F, acc_delta, rho, F.square(delta))
    return F.sub(weight, delta), acc_g, acc_delta


def lars_rule(F, weight, grad, mom, lr, eta=0.001, momentum=0.9, wd=0.0,
              epsilon=1e-9, rescale_grad=1.0, clip_gradient=-1.0):
    """LARS layer-wise adaptive SGD (reference: lars_update and the LBSGD
    optimizer): the layer's lr is scaled by eta * ||w|| / (||g|| + wd *
    ||w|| + eps), then an SGD-momentum step runs with it."""
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    w_norm, g_norm = F.norm(weight), F.norm(grad)
    ratio = F.trust(w_norm, g_norm,
                    eta * w_norm / (g_norm + wd * w_norm + epsilon))
    mom = F.sub(F.mul(mom, momentum),
                F.mul(_decayed(F, grad, weight, wd), lr * ratio))
    return F.add(weight, mom), mom


def ftml_rule(F, weight, grad, d, v, z, lr, t=1, beta1=0.6, beta2=0.999,
              epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML, Follow The Moving Leader (reference: ftml_update; Zheng & Kwok
    2017).  States d, v, z; weight decay is folded in before the clip, and
    the clip is named ``clip_grad``."""
    return ftml_fused_rule(F, weight, grad, d, v, z,
                           c_over_lr=(1.0 - beta1 ** t) / lr,
                           coef2=1.0 - beta2 ** t, wd=wd, beta1=beta1,
                           beta2=beta2, epsilon=epsilon,
                           rescale_grad=rescale_grad, clip_grad=clip_grad)


def ftml_fused_rule(F, weight, grad, d, v, z, c_over_lr, coef2, wd,
                    beta1=0.6, beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                    clip_grad=-1.0):
    """FTML with the step-count terms folded on the host:
    ``c_over_lr = (1 - beta1**t) / lr`` and ``coef2 = 1 - beta2**t``."""
    grad = _clipped(F, _decayed(F, F.mul(grad, rescale_grad), weight, wd),
                    clip_grad)
    v = _ema(F, v, beta2, F.square(grad))
    d_t = F.mul(F.add(F.sqrt(F.div(v, coef2)), epsilon), c_over_lr)
    sigma = F.sub(d_t, F.mul(d, beta1))
    z = F.sub(_ema(F, z, beta1, grad), F.mul(weight, sigma))
    return F.div(F.neg(z), d_t), d_t, v, z


def _lamb_phase1(F, weight, grad, mean, var, beta1, beta2, epsilon, wd,
                 rescale_grad, clip_gradient, denom1, denom2):
    grad = _rescale(F, grad, rescale_grad, clip_gradient)
    mean, var = _adam_moments(F, grad, mean, var, beta1, beta2)
    mhat, vhat = mean, var
    if denom1 is not None:
        mhat, vhat = F.div(mean, denom1), F.div(var, denom2)
    g_new = F.add(F.div(mhat, F.add(F.sqrt(vhat), epsilon)),
                  F.mul(weight, wd))
    return g_new, mean, var


def _lamb_ratio(F, r1, r2, lower_bound, upper_bound):
    if lower_bound is not None and lower_bound > 0:
        r1 = F.scalar_max(r1, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = F.scalar_min(r1, upper_bound)
    return F.trust(r1, r2, r1 / r2)


def lamb_phase1_rule(F, weight, grad, mean, var, t=1, beta1=0.9, beta2=0.999,
                     epsilon=1e-6, wd=0.0, bias_correction=True,
                     rescale_grad=1.0, clip_gradient=-1.0):
    denoms = (1.0 - beta1 ** t, 1.0 - beta2 ** t) if bias_correction \
        else (None, None)
    return _lamb_phase1(F, weight, grad, mean, var, beta1, beta2, epsilon,
                        wd, rescale_grad, clip_gradient, *denoms)


def lamb_phase2_rule(F, weight, g, r1, r2, lr, lower_bound=-1.0,
                     upper_bound=-1.0):
    ratio = _lamb_ratio(F, r1, r2, lower_bound, upper_bound)
    return (F.sub(weight, F.mul(g, lr * ratio)),)


def lamb_fused_rule(F, weight, grad, mean, var, lr, wd, denom1, denom2,
                    beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                    clip_gradient=-1.0, lower_bound=-1.0, upper_bound=-1.0):
    """One LAMB step: phase 1, the trust-ratio norms and phase 2.
    ``denom1``/``denom2`` are the host-folded ``1 - beta**t`` (1.0 with
    ``bias_correction=False``: ``x / 1.0`` is exact)."""
    g_new, mean, var = _lamb_phase1(F, weight, grad, mean, var, beta1, beta2,
                                    epsilon, wd, rescale_grad, clip_gradient,
                                    denom1, denom2)
    ratio = _lamb_ratio(F, F.norm(weight), F.norm(g_new), lower_bound,
                        upper_bound)
    return F.sub(weight, F.mul(g_new, lr * ratio)), mean, var


# -- single-tensor pure updates ------------------------------------------------

def _pure(rule, name):
    def pure(*args, **kwargs):
        return rule(TENSOR, *args, **kwargs)

    pure.__name__ = name
    pure.__qualname__ = name
    pure.__doc__ = rule.__doc__
    pure.rule = rule
    return pure


sgd_update_pure = _pure(sgd_rule, "sgd_update_pure")
sgd_mom_update_pure = _pure(sgd_mom_rule, "sgd_mom_update_pure")
nag_mom_update_pure = _pure(nag_mom_rule, "nag_mom_update_pure")
adam_update_pure = _pure(adam_rule, "adam_update_pure")
adamw_update_pure = _pure(adamw_rule, "adamw_update_pure")
rmsprop_update_pure = _pure(rmsprop_rule, "rmsprop_update_pure")
rmspropalex_update_pure = _pure(rmspropalex_rule, "rmspropalex_update_pure")
ftrl_update_pure = _pure(ftrl_rule, "ftrl_update_pure")
signsgd_update_pure = _pure(signsgd_rule, "signsgd_update_pure")
signum_update_pure = _pure(signum_rule, "signum_update_pure")
adagrad_update_pure = _pure(adagrad_rule, "adagrad_update_pure")
adadelta_update_pure = _pure(adadelta_rule, "adadelta_update_pure")
lars_update_pure = _pure(lars_rule, "lars_update_pure")
ftml_update_pure = _pure(ftml_rule, "ftml_update_pure")
ftml_fused_update_pure = _pure(ftml_fused_rule, "ftml_fused_update_pure")
lamb_update_phase1_pure = _pure(lamb_phase1_rule, "lamb_update_phase1_pure")
lamb_update_phase2_pure = _pure(lamb_phase2_rule, "lamb_update_phase2_pure")
lamb_fused_update_pure = _pure(lamb_fused_rule, "lamb_fused_update_pure")


# -- multi-precision variants (f32 master weight, last positional state) -------

def _mp(pure_fn):
    def mp_fn(weight, grad, *states_and_w32, **kwargs):
        *states, weight32 = states_and_w32
        out = pure_fn(weight32, grad.to(torch.float32), *states, **kwargs)
        return (out[0].to(weight.dtype),) + tuple(out[1:]) + (out[0],)

    mp_fn.__name__ = "mp_" + pure_fn.__name__
    return mp_fn


mp_sgd_update_pure = _mp(sgd_update_pure)
mp_sgd_mom_update_pure = _mp(sgd_mom_update_pure)
mp_nag_mom_update_pure = _mp(nag_mom_update_pure)
mp_adam_update_pure = _mp(adam_update_pure)
mp_lamb_update_phase1_pure = _mp(lamb_update_phase1_pure)
mp_lars_update_pure = _mp(lars_update_pure)


# -- NDArray wrappers (the reference's in-place contract) ----------------------

def _register_update(name, pure_fn):
    """``mx.nd.<name>(weight, grad, *states, **hyper)``: the states are
    overwritten in place, the new weight is returned (or written to
    ``out=``, which the invoke layer handles); on raw tensors the pure
    function runs as is."""

    @register(name, opaque=True)
    def wrapper(*args, **kwargs):
        from ..ndarray.ndarray import NDArray

        if not any(isinstance(a, NDArray) for a in args):
            return pure_fn(*args, **kwargs)
        res = pure_fn(*[a._data if isinstance(a, NDArray) else a
                        for a in args], **kwargs)
        for arr, new in zip([a for a in args[2:] if isinstance(a, NDArray)],
                            res[1:]):
            arr._set_data(new)
        return NDArray(res[0], args[0]._ctx)

    wrapper.__name__ = name
    return wrapper


for _name, _fn in [
    ("sgd_update", sgd_update_pure),
    ("sgd_mom_update", sgd_mom_update_pure),
    ("nag_mom_update", nag_mom_update_pure),
    ("adam_update", adam_update_pure),
    ("adamw_update", adamw_update_pure),
    ("rmsprop_update", rmsprop_update_pure),
    ("rmspropalex_update", rmspropalex_update_pure),
    ("ftrl_update", ftrl_update_pure),
    ("signsgd_update", signsgd_update_pure),
    ("signum_update", signum_update_pure),
    ("adagrad_update", adagrad_update_pure),
    ("adadelta_update", adadelta_update_pure),
    ("lars_update", lars_update_pure),
    ("mp_lars_update", mp_lars_update_pure),
    ("ftml_update", ftml_update_pure),
    ("lamb_update_phase1", lamb_update_phase1_pure),
    ("lamb_update_phase2", lamb_update_phase2_pure),
    ("mp_sgd_update", mp_sgd_update_pure),
    ("mp_sgd_mom_update", mp_sgd_mom_update_pure),
    ("mp_nag_mom_update", mp_nag_mom_update_pure),
    ("mp_adam_update", mp_adam_update_pure),
    ("mp_lamb_update_phase1", mp_lamb_update_phase1_pure),
]:
    _register_update(_name, _fn)


# -- single-parameter dispatch -------------------------------------------------
#
# The per-step scalars of each rule: they enter as 0-dim tensors of the
# weight's dtype (the reference's host-side cast), every other keyword is
# a Python constant.  The grouped path (optimizer/grouped.py) casts the
# same names to the group dtype, so both paths round them alike.

DYN_ARGS = {
    "adadelta_update_pure": ("wd", "rescale_grad"),
    "ftml_update_pure": ("wd", "rescale_grad"),
    "lamb_update_phase1_pure": ("wd", "rescale_grad"),
    "lamb_update_phase2_pure": ("lr",),
    "lamb_fused_update_pure": ("lr", "wd", "rescale_grad", "denom1",
                               "denom2"),
    "ftml_fused_update_pure": ("c_over_lr", "coef2", "wd", "rescale_grad"),
}
DEFAULT_DYN = ("lr", "wd", "rescale_grad")


def dyn_names(pure_fn, kwargs):
    """The per-step scalar names of ``pure_fn`` present in ``kwargs``."""
    return tuple(n for n in DYN_ARGS.get(pure_fn.__name__, DEFAULT_DYN)
                 if n in kwargs)


def fused_dispatch(pure_fn, weight, grad, states, kwargs):
    """``pure_fn(weight, grad, *states, **kwargs)`` with the per-step
    scalars as 0-dim tensors of the weight's dtype on its device.  Tensors
    in, tensors out."""
    kw = dict(kwargs)
    for n in dyn_names(pure_fn, kwargs):
        kw[n] = torch.tensor(kwargs[n], dtype=weight.dtype,
                             device=weight.device)
    return pure_fn(weight, grad, *states, **kw)


PURE_UPDATES = {
    "sgd_update": sgd_update_pure,
    "sgd_mom_update": sgd_mom_update_pure,
    "nag_mom_update": nag_mom_update_pure,
    "adam_update": adam_update_pure,
    "adamw_update": adamw_update_pure,
    "rmsprop_update": rmsprop_update_pure,
    "rmspropalex_update": rmspropalex_update_pure,
    "ftrl_update": ftrl_update_pure,
    "signsgd_update": signsgd_update_pure,
    "signum_update": signum_update_pure,
    "adagrad_update": adagrad_update_pure,
    "adadelta_update": adadelta_update_pure,
    "lars_update": lars_update_pure,
    "ftml_update": ftml_update_pure,
}
