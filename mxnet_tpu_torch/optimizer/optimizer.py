"""Optimizer registry, the built-in optimizers and the per-parameter
``Updater``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference:
python/mxnet/optimizer/optimizer.py): the ``Optimizer`` base (registry,
lr/wd multipliers, update counting, multi-precision, the LR scheduler
hook), the 18 registered optimizers, and ``Updater``/``get_updater``.

Each update runs one rule of ``ops.optimizer_op`` on the parameter's
tensors through ``fused_dispatch`` and writes the results into the
weight's and the states' own tensors in place.  ``multi_precision`` keeps
an f32 master copy for float16 weights, as the reference does, and for
bfloat16 weights too (the JAX package updates those in bf16): the update
runs on the master and the model weight is rounded from it.
"""

from __future__ import annotations

import logging
import math
import pickle

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import optimizer_op as _op

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _zeros_like(weight):
    return NDArray(torch.zeros_like(weight._data.detach()), weight._ctx)


@torch.no_grad()
def _assign(nd, t):
    """Write ``t`` into ``nd``'s tensor in place (its memory stays put, so
    a captured CUDA graph that reads it sees the new value)."""
    nd._data.copy_(t)
    nd._version += 1


class Optimizer:
    """Base class for optimizers (reference: mx.optimizer.Optimizer)."""

    opt_registry: dict = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise ValueError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        # a symbol's per-variable multipliers (``lr_mult``/``__lr_mult__``
        # attributes, what ``AttrScope`` sets) feed lr_mult/wd_mult
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        assert isinstance(klass, type)
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("WARNING: New optimizer %s.%s is overriding "
                            "existing optimizer %s.%s", klass.__module__,
                            klass.__name__,
                            Optimizer.opt_registry[name].__module__,
                            Optimizer.opt_registry[name].__name__)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    def create_state(self, index, weight):
        return None

    def _mp_weight(self, weight):
        """Whether ``weight`` keeps an f32 master copy."""
        return self.multi_precision and weight._data.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        if self._mp_weight(weight):
            master = NDArray(weight._data.detach().to(torch.float32),
                             weight._ctx)
            return (master, self.create_state(index, master))
        if weight._data.dtype == torch.float16:
            logging.warning("Accumulating with float16 in optimizer can lead "
                            "to poor accuracy or slow convergence. Consider "
                            "using multi_precision=True option of the "
                            "optimizer")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self._mp_weight(weight):
            master, original_state = state
            grad32 = NDArray(grad._data.to(torch.float32), grad._ctx)
            self.update(index, master, grad32, original_state)
            _assign(weight, master._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    @staticmethod
    def _sym_mult(attrs, key):
        """A variable's multiplier attribute: the reference's dunder form
        (``__lr_mult__``) or ``var(lr_mult=...)``'s plain key."""
        if f"__{key}__" in attrs:
            return float(attrs[f"__{key}__"])
        if key in attrs:
            return float(attrs[key])
        return None

    def _sym_mults(self, key):
        out = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                m = self._sym_mult(attr.get(name, {}), key)
                if m is not None:
                    out[name] = m
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("lr_mult")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not n.endswith("_weight"):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(self._sym_mults("wd_mult"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lrs(self, indices):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        lrs = [lr for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                lrs[i] *= self.param_dict[index].lr_mult
            elif index in self.lr_mult:
                lrs[i] *= self.lr_mult[index]
            elif index in self.idx2name:
                lrs[i] *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lrs

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        wds = [self.wd for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                wds[i] *= self.param_dict[index].wd_mult
            elif index in self.wd_mult:
                wds[i] *= self.wd_mult[index]
            elif index in self.idx2name:
                wds[i] *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wds

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def __getstate__(self):
        ret = self.__dict__.copy()
        del ret["param_dict"]
        return ret

    def __setstate__(self, state):
        self.__dict__ = state
        self.param_dict = {}

    def _common(self):
        """The keywords every rule takes."""
        kw = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def _apply(self, pure_fn, weight, states, grad, **kwargs):
        """Run one rule on the parameter's tensors (``fused_dispatch``) and
        write the results into the weight and the states in place.

        A row-sparse gradient takes the reference's lazy update: the same
        rule runs on just the stored rows of the weight and the states
        (every rule is elementwise, so this is exact) and the rows go
        back in place; untouched rows and their states never move.  With
        ``lazy_update=False`` the gradient is densified and every row
        steps (momentum decays, weight decay applies), as the reference
        does."""
        from ..ndarray.sparse import RowSparseNDArray

        if isinstance(grad, RowSparseNDArray):
            if getattr(self, "lazy_update", True):
                self._apply_rows(pure_fn, weight, states, grad, kwargs)
                return
            grad = NDArray(grad._data, grad._ctx)
        with torch.no_grad():
            res = _op.fused_dispatch(pure_fn, weight._data, grad._data,
                                     [s._data for s in states], kwargs)
        _assign(weight, res[0])
        for s, new in zip(states, res[1:]):
            _assign(s, new)

    @torch.no_grad()
    def _apply_rows(self, pure_fn, weight, states, grad, kwargs):
        ids = grad._rs_indices
        w = weight._data
        rows = [w.index_select(0, ids)] + [s._data.index_select(0, ids)
                                           for s in states]
        res = _op.fused_dispatch(pure_fn, rows[0],
                                 grad._rs_values.to(w.dtype), rows[1:],
                                 kwargs)
        for nd, new in zip([weight, *states], res):
            nd._data.index_copy_(0, ids, new)
            nd._version += 1

    def _clipped_grad(self, grad, weight=None, wd=0.0):
        """``rescale * grad (+ wd * weight)``, clipped: the inline
        optimizers' gradient."""
        g = grad._data * self.rescale_grad
        if weight is not None:
            g = g + wd * weight._data
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum (reference: sgd_update / sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            self._apply(_op.sgd_mom_update_pure, weight, [state], grad,
                        lr=lr, wd=wd, momentum=self.momentum,
                        **self._common())
        else:
            self._apply(_op.sgd_update_pure, weight, [], grad, lr=lr, wd=wd,
                        **self._common())


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: nag_mom_update)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            self._apply(_op.nag_mom_update_pure, weight, [state], grad,
                        lr=lr, wd=wd, momentum=self.momentum,
                        **self._common())
        else:
            self._apply(_op.sgd_update_pure, weight, [], grad, lr=lr, wd=wd,
                        **self._common())


def _bias_corrected(opt, index, lr):
    t = opt._index_update_count[index]
    return lr * (math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t))


@register
class Adam(Optimizer):
    """Adam (reference: adam_update; bias correction folded into lr as
    python/mxnet/optimizer/optimizer.py does)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = _bias_corrected(self, index, self._get_lr(index))
        self._apply(_op.adam_update_pure, weight, list(state), grad, lr=lr,
                    wd=self._get_wd(index), beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, **self._common())


@register
class Adamax(Optimizer):
    """AdaMax, the infinity-norm Adam (reference: Adamax python impl)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        m_t, u_t = state
        g = self._clipped_grad(grad, weight, wd)
        new_m = self.beta1 * m_t._data + (1.0 - self.beta1) * g
        new_u = torch.maximum(self.beta2 * u_t._data, torch.abs(g))
        _assign(m_t, new_m)
        _assign(u_t, new_u)
        _assign(weight, weight._data - lr * new_m / (new_u + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference: Nadam python impl)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._clipped_grad(grad, weight, wd)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        g_prime = g / (1.0 - self.m_schedule)
        new_m = self.beta1 * m_t._data + (1.0 - self.beta1) * g
        new_v = self.beta2 * v_t._data + (1.0 - self.beta2) * g * g
        m_t_prime = new_m / (1.0 - m_schedule_next)
        v_t_prime = new_v / (1.0 - self.beta2 ** t)
        m_t_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_t_prime
        _assign(m_t, new_m)
        _assign(v_t, new_v)
        _assign(weight, weight._data - lr * m_t_bar
                / (torch.sqrt(v_t_prime) + self.epsilon))


@register
class RMSProp(Optimizer):
    """RMSProp, centered or not (reference: rmsprop_update /
    rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))      # n, g, delta
        return (_zeros_like(weight),)        # n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common()
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            self._apply(_op.rmspropalex_update_pure, weight, list(state),
                        grad, lr=lr, wd=wd, gamma1=self.gamma1,
                        gamma2=self.gamma2, epsilon=self.epsilon, **kw)
        else:
            self._apply(_op.rmsprop_update_pure, weight, list(state), grad,
                        lr=lr, wd=wd, gamma1=self.gamma1,
                        epsilon=self.epsilon, **kw)


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: AdaGrad python impl over _internal ops)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply(_op.adagrad_update_pure, weight, [state], grad,
                    lr=self._get_lr(index), wd=self._get_wd(index),
                    epsilon=self.float_stable_eps, **self._common())


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: AdaDelta python impl)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply(_op.adadelta_update_pure, weight, list(state), grad,
                    rho=self.rho, epsilon=self.epsilon,
                    wd=self._get_wd(index), **self._common())


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: ftrl_update)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply(_op.ftrl_update_pure, weight, list(state), grad,
                    lr=self._get_lr(index), wd=self._get_wd(index),
                    lamda1=self.lamda1, beta=self.beta, **self._common())


@register
class Signum(Optimizer):
    """Signum / SignSGD (reference: signum_update / signsgd_update)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            self._apply(_op.signum_update_pure, weight, [state], grad,
                        lr=lr, wd=wd, momentum=self.momentum,
                        wd_lh=self.wd_lh, **self._common())
        else:
            self._apply(_op.signsgd_update_pure, weight, [], grad, lr=lr,
                        wd=wd, **self._common())


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: SGLD python impl);
    the noise draws from the package's generator chain."""

    def create_state(self, index, weight):
        return None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        from ..random import current_generator

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._clipped_grad(grad)
        w = weight._data
        noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                            generator=current_generator(w.device)) \
            * math.sqrt(lr)
        _assign(weight, w - lr / 2 * (g + wd * w) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: DCASGD python
    impl)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = NDArray(weight._data.detach().clone(), weight._ctx)
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros_like(weight), prev)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._clipped_grad(grad)
        mom, previous_weight = state
        w = weight._data.clone()
        comp = g + wd * w + self.lamda * g * g * (w - previous_weight._data)
        if mom is not None:
            delta = self.momentum * mom._data - lr * comp
            _assign(mom, delta)
        else:
            delta = -lr * comp
        _assign(previous_weight, w)
        _assign(weight, w + delta)


@register
class LAMB(Optimizer):
    """LAMB, the layer-wise adaptive large-batch optimizer (reference:
    lamb_update_phase1/2); one fused rule: phase 1, the trust-ratio norms
    and phase 2."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction
        self.lazy_update = False     # trust ratios need the whole tensor

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        if self.bias_correction:
            denom1, denom2 = 1.0 - self.beta1 ** t, 1.0 - self.beta2 ** t
        else:
            denom1 = denom2 = 1.0     # x / 1.0 is exact
        kw = {}
        if self.lower_bound is not None:
            kw["lower_bound"] = self.lower_bound
        if self.upper_bound is not None:
            kw["upper_bound"] = self.upper_bound
        self._apply(_op.lamb_fused_update_pure, weight, list(state), grad,
                    lr=self._get_lr(index), wd=self._get_wd(index),
                    denom1=denom1, denom2=denom2, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, **kw,
                    **self._common())


@register
class LARS(Optimizer):
    """LARS layer-wise adaptive SGD for large batches (reference: LBSGD
    and lars_update).  1-D parameters (biases, BatchNorm's gamma and beta)
    take the plain SGD-momentum step, the reference's skip list."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if len(weight.shape) <= 1:
            self._apply(_op.sgd_mom_update_pure, weight, [state], grad,
                        lr=lr, wd=wd, momentum=self.momentum,
                        **self._common())
        else:
            self._apply(_op.lars_update_pure, weight, [state], grad,
                        lr=lr, wd=wd, momentum=self.momentum, eta=self.eta,
                        epsilon=self.epsilon, **self._common())


@register
class FTML(Optimizer):
    """Follow The Moving Leader (reference: FTML and ftml_update; Zheng &
    Kwok, ICML 2017)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))   # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common()
        kw["clip_grad"] = kw.pop("clip_gradient", -1.0)   # the op's name
        self._apply(_op.ftml_fused_update_pure, weight, list(state), grad,
                    c_over_lr=(1.0 - self.beta1 ** t) / self._get_lr(index),
                    coef2=1.0 - self.beta2 ** t, wd=self._get_wd(index),
                    beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon, **kw)


@register
class LBSGD(LARS):
    """Large-Batch SGD (reference: LBSGD): LARS's layer-wise rates plus a
    warmup of the batch-scaled lr, from ``learning_rate`` to
    ``learning_rate * batch_scale`` over ``warmup_epochs *
    updates_per_epoch`` updates by ``warmup_strategy`` ('linear', 'power2',
    'sqrt'; 'lars' ramps linearly; None jumps to the scaled lr).
    ``begin_epoch``/``num_epochs`` are accepted for the reference's
    signature."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        if warmup_strategy == "lars":
            warmup_strategy = "linear"
        elif warmup_strategy not in ("linear", "power2", "sqrt", None):
            raise MXNetError(
                f"LBSGD: unknown warmup_strategy {warmup_strategy!r} "
                f"(expected linear|power2|sqrt|lars|None)")
        self.warmup_strategy = warmup_strategy
        self.batch_scale = float(batch_scale)
        self.warmup_updates = max(1, int(warmup_epochs)
                                  * max(1, int(updates_per_epoch)))

    def _get_lr(self, index):
        lr = super()._get_lr(index)
        t = max(self._index_update_count.get(index, 1), 1)
        frac = min(t / self.warmup_updates, 1.0)
        if self.warmup_strategy == "power2":
            frac = frac * frac
        elif self.warmup_strategy == "sqrt":
            frac = frac ** 0.5
        elif self.warmup_strategy is None:
            return lr * self.batch_scale
        return lr * (1.0 + frac * (self.batch_scale - 1.0))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (reference: contrib.AdamW)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = _bias_corrected(self, index, self._get_lr(index))
        self._apply(_op.adamw_update_pure, weight, list(state), grad, lr=lr,
                    wd=self._get_wd(index), beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, **self._common())


@register
class Test(Optimizer):
    """Test optimizer (reference: mx.optimizer.Test): w -= lr * grad."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _assign(weight, weight._data - self.lr * self.rescale_grad
                * grad._data)


class Updater:
    """Applies an Optimizer to (index, grad, weight) triples and owns the
    states (reference: mx.optimizer.Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = False

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            indices, grads, weights = [index], [grad], [weight]
        else:
            indices, grads, weights = index, grad, weight
        for i, g, w in zip(indices, grads, weights):
            self.ensure_state(i, w)
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def ensure_state(self, index, weight):
        """Create ``index``'s state, or move loaded state to the weight's
        device, before its first update."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = self.sync_state_context(
                self.states[index], weight.context)
            self.states_synced[index] = True

    def sync_state_context(self, state, context):
        """``state`` with every NDArray on ``context``."""
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, (tuple, list)):
            return type(state)(self.sync_state_context(s, context)
                               for s in state)
        return state

    def set_states(self, states):
        """Load a ``get_states`` pickle (states as host arrays): they land
        on the host and move to each weight's device at its next update."""
        from ..context import cpu

        with cpu():
            states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer)
                            if dump_optimizer else self.states)


def get_updater(optimizer):
    return Updater(optimizer)
