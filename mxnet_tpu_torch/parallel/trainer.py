"""The training step on one device: ``ShardedTrainer`` and its pure
optimizer.

Counterpart of ``mxnet_tpu/parallel/trainer.py``.  The JAX package
compiles forward, backward and the optimizer update into one program over
a device mesh; here one device runs them eagerly, in the same order and
with the same arithmetic:

- forward in training mode (``Module.train()`` for the zoo's
  ``nn.Module``s, ``autograd.train_mode()`` for Gluon blocks), dropout
  drawing from one generator per step (``random.step_generator``, the
  step's ``next_key()``); a Gluon block's BatchNorm moves its running
  statistics in place, once per microbatch, as the JAX step's scan carry
  does;
- the mean loss and its gradients (``torch.autograd.grad``); with
  ``grad_accum=k`` dim 0 is split into k microbatches whose losses and
  gradients are averaged;
- one pure update (``_PureOptimizer.apply``) with ``rescale=1``, since the
  gradients are of the mean loss; the results are copied into the module's
  own parameters in place, so the module always holds the trained weights;
- the module's previous train/eval mode restored;
- with ``remat`` (or ``MXTPU_REMAT``/``MXNET_BACKWARD_DO_MIRROR``) the
  forward and loss run as one rematerialised region (``remat.wrap``), as
  the JAX step wraps its loss function.

``mesh`` may be a ``parallel.Mesh`` of one device (``data_parallel_mesh(1)``,
as the JAX package's bench passes), which must be the device the module's
parameters live on.  Multi-device meshes, sharding rules and ``mode``
(tp/fsdp) come with the multi-GPU slice and raise ``NotImplementedError``;
``state_dict`` waits for the checkpoint slice.
"""

from __future__ import annotations

import math

import torch

from .. import autograd as _ag
from .. import random as _random
from .. import remat as _remat
from ..base import MXNetError
from ..ops import optimizer_op as _op
from .mesh import Mesh


class _PureOptimizer:
    """Pure-functional optimizer over a list of parameter tensors, with the
    JAX package's seven update rules.  State tensors take the parameter's
    dtype; the update runs in f32 and is cast back to the parameter's
    dtype, as the JAX update's f32 learning rate promotes it."""

    def __init__(self, name, lr=0.01, momentum=0.0, wd=0.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, clip_gradient=None,
                 lr_scheduler=None, gamma1=None, rho=None, gamma2=0.9,
                 centered=False, lower_bound=None, upper_bound=None,
                 clip_weights=None, lazy_update=True, **unknown):
        self.name = name.lower()
        self.lr = lr
        self.momentum = momentum
        self.wd = wd
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        # rmsprop decay: reference calls it gamma1, torch-style calls rho
        self.gamma1 = gamma1 if gamma1 is not None else \
            (rho if rho is not None else 0.9)
        self.gamma2 = gamma2
        self.centered = bool(centered)
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.clip_weights = clip_weights
        if unknown:
            import warnings

            warnings.warn(
                f"ShardedTrainer: ignoring optimizer hyperparameters "
                f"{sorted(unknown)} for {name}", stacklevel=3)
        if self.name not in ("sgd", "nag", "adam", "adamw", "lamb",
                             "rmsprop", "adagrad"):
            raise MXNetError(f"ShardedTrainer: unsupported optimizer "
                             f"{name}")

    def lr_at(self, num_update):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(num_update)
        return self.lr

    def n_states(self):
        if self.name == "rmsprop":
            return 3 if self.centered else 1
        return {"sgd": 1, "nag": 1, "adagrad": 1,
                "adam": 2, "adamw": 2, "lamb": 2}[self.name]

    def init_state(self, param_vals):
        n = self.n_states()
        return [tuple(torch.zeros_like(p) for _ in range(n))
                for p in param_vals]

    def apply(self, param_vals, grads, states, lr, t, wd_mults, lr_mults,
              rescale):
        """One pure update over all params; returns (new_params,
        new_states) as new tensors."""
        kw = {"rescale_grad": rescale}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        new_p, new_s = [], []
        for p0, g, s0, wm, lm in zip(param_vals, grads, states, wd_mults,
                                     lr_mults):
            p, g = p0.float(), g.float()
            s = tuple(x.float() for x in s0)
            wd = self.wd * wm
            plr = lr * lm
            if self.name == "sgd":
                if self.momentum:
                    w, mom = _op.sgd_mom_update_pure(
                        p, g, s[0], lr=plr, momentum=self.momentum, wd=wd,
                        **kw)
                    s_out = (mom,)
                else:
                    (w,) = _op.sgd_update_pure(p, g, lr=plr, wd=wd, **kw)
                    s_out = s
            elif self.name == "nag":
                w, mom = _op.nag_mom_update_pure(
                    p, g, s[0], lr=plr, momentum=self.momentum, wd=wd, **kw)
                s_out = (mom,)
            elif self.name in ("adam", "adamw"):
                coef1 = 1.0 - self.beta1 ** t
                coef2 = 1.0 - self.beta2 ** t
                lr_t = plr * math.sqrt(coef2) / coef1
                fn = _op.adam_update_pure if self.name == "adam" else \
                    _op.adamw_update_pure
                w, m, v = fn(p, g, s[0], s[1], lr=lr_t, beta1=self.beta1,
                             beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                             **kw)
                s_out = (m, v)
            elif self.name == "lamb":
                gnew, m, v = _op.lamb_update_phase1_pure(
                    p, g, s[0], s[1], t=t, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, wd=wd, **kw)
                r1 = torch.linalg.vector_norm(p)
                r2 = torch.linalg.vector_norm(gnew)
                bounds = {}
                if self.lower_bound is not None:
                    bounds["lower_bound"] = self.lower_bound
                if self.upper_bound is not None:
                    bounds["upper_bound"] = self.upper_bound
                (w,) = _op.lamb_update_phase2_pure(p, gnew, r1, r2, lr=plr,
                                                   **bounds)
                s_out = (m, v)
            elif self.name == "rmsprop":
                cw = {"clip_weights": self.clip_weights} \
                    if self.clip_weights is not None else {}
                if self.centered:
                    w, n, gm, d = _op.rmspropalex_update_pure(
                        p, g, s[0], s[1], s[2], lr=plr, gamma1=self.gamma1,
                        gamma2=self.gamma2, epsilon=self.epsilon, wd=wd,
                        **kw, **cw)
                    s_out = (n, gm, d)
                else:
                    w, n = _op.rmsprop_update_pure(
                        p, g, s[0], lr=plr, gamma1=self.gamma1,
                        epsilon=self.epsilon, wd=wd, **kw, **cw)
                    s_out = (n,)
            elif self.name == "adagrad":
                w, h = _op.adagrad_update_pure(
                    p, g, s[0], lr=plr, epsilon=self.epsilon, wd=wd, **kw)
                s_out = (h,)
            new_p.append(w.to(p0.dtype))
            new_s.append(tuple(s_new.to(s_old.dtype)
                               for s_new, s_old in zip(s_out, s0)))
        return new_p, new_s


def _tree_map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, a) for a in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, a) for k, a in x.items()}
    return fn(x)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for a in x for leaf in _leaves(a)]
    if isinstance(x, dict):
        return [leaf for a in x.values() for leaf in _leaves(a)]
    return [x]


class ShardedTrainer:
    """Train an ``nn.Module`` or a Gluon ``Block`` with one optimizer step
    per ``step`` call.

    Usage, as in the JAX package at one device::

        trainer = parallel.ShardedTrainer(net, loss_fn, 'adamw',
                                          {'learning_rate': 3e-4})
        loss = trainer.step(x, y)     # forward, backward, update

    ``mesh`` is None or a ``Mesh`` of one device; ``rules`` and ``mode``
    must be None: the multi-GPU trainer is a later slice.  Outputs and
    labels may be tuples (BERT's four outputs, its two label arrays): they
    reach ``loss_fn`` as they came."""

    def __init__(self, block, loss_fn, optimizer="sgd",
                 optimizer_params=None, mesh=None, rules=None,
                 batch_axis="dp", grad_accum=1, remat=None, mode=None):
        if rules is not None or mode is not None or not (
                mesh is None or (isinstance(mesh, Mesh) and mesh.size == 1)):
            raise NotImplementedError(
                "ShardedTrainer: meshes of more than one device, sharding "
                "rules and tp/fsdp modes are not ported yet; the port "
                "trains on one device")
        self.block = block
        self.remat = remat
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.batch_axis = batch_axis
        opt_kwargs = dict(optimizer_params or {})
        lr = opt_kwargs.pop("learning_rate", opt_kwargs.pop("lr", 0.01))
        self.optimizer = _PureOptimizer(optimizer, lr=lr, **opt_kwargs)
        self._grad_accum = int(grad_accum)
        if self._grad_accum < 1:
            raise ValueError(f"ShardedTrainer: grad_accum must be >= 1, got "
                             f"{grad_accum}")
        self._num_update = 0
        self._initialized = False

    def _stage(self, example):
        """Collect the trainable parameters and zero the optimizer state.
        A Gluon block's deferred parameters first materialise from one
        forward of ``example`` in predict mode, outside the tape, which
        leaves BatchNorm's running statistics as they were; its trainable
        parameters are those with ``grad_req != "null"``, each with its
        own ``wd_mult``/``lr_mult``; the rest (running statistics) are its
        aux state, which the forward updates in place."""
        if hasattr(self.block, "collect_params"):
            allp = list(self.block.collect_params().items())
            ctx = next((c for _, p in allp for c in p.list_ctx()), None)
            if ctx is not None:
                self.block._ensure_initialized(_tree_map(
                    lambda a: torch.as_tensor(a, device=ctx.device),
                    example))
            self._trainable = [(n, p._value()) for n, p in allp
                               if p.grad_req != "null"]
            mults = [(p.wd_mult, p.lr_mult) for _, p in allp
                     if p.grad_req != "null"]
        else:
            self._trainable = [(n, p) for n, p in
                               self.block.named_parameters()
                               if p.requires_grad]
            mults = [(getattr(p, "wd_mult", 1.0), getattr(p, "lr_mult", 1.0))
                     for _, p in self._trainable]
        if not self._trainable:
            raise MXNetError("ShardedTrainer: the block has no trainable "
                             "parameters")
        self._device = self._trainable[0][1].device
        if self.mesh is not None:
            (mesh_dev,) = self.mesh.devices.flat
            if torch.device(mesh_dev) != self._device:
                raise MXNetError(f"ShardedTrainer: the mesh holds "
                                 f"{mesh_dev}, the block's parameters are on "
                                 f"{self._device}")
        self._opt_state = self.optimizer.init_state(
            [p.detach() for _, p in self._trainable])
        self._wd_mults = [w for w, _ in mults]
        self._lr_mults = [lm for _, lm in mults]
        self._initialized = True

    def _to_device(self, x):
        return _tree_map(lambda a: torch.as_tensor(a, device=self._device), x)

    def _loss_of(self, x, y):
        out = self.block(x)
        loss = self.loss_fn(out, y) if self.loss_fn is not None else out
        return loss.mean()

    def _loss_and_grads(self, x, y):
        loss = _remat.wrap(self._loss_of, self.remat)(x, y)
        params = [p for _, p in self._trainable]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def _microbatches(self, x, y):
        k = self._grad_accum
        for leaf in _leaves(x) + _leaves(y):
            if leaf.shape[0] % k:
                raise ValueError(f"ShardedTrainer: batch dim "
                                 f"{leaf.shape[0]} not divisible by "
                                 f"grad_accum={k}")
        for i in range(k):
            yield (_tree_map(lambda a: a.chunk(k)[i], x),
                   _tree_map(lambda a: a.chunk(k)[i], y))

    def step(self, data, label):
        """One training step; returns the mean loss as a 0-dim tensor.
        ``data``/``label`` may be tensors, arrays, or tuples/lists/dicts
        of them, batch-major on dim 0.  With ``grad_accum=k`` the batch is
        split into k microbatches and one update applies their averaged
        gradients."""
        if not self._initialized:
            self._stage(data)
        x, y = self._to_device(data), self._to_device(label)
        self._num_update += 1
        t = self._num_update
        lr = self.optimizer.lr_at(t)
        was_training = self.block.training
        self.block.train()
        try:
            with _random.generator_scope(
                    _random.step_generator(self._device)), \
                    _ag.train_mode():
                if self._grad_accum == 1:
                    loss, grads = self._loss_and_grads(x, y)
                else:
                    loss, grads = 0.0, None
                    for xb, yb in self._microbatches(x, y):
                        l, g = self._loss_and_grads(xb, yb)
                        loss = loss + l
                        grads = g if grads is None else [
                            a + b for a, b in zip(grads, g)]
                    loss = loss / self._grad_accum
                    grads = [g / self._grad_accum for g in grads]
        finally:
            self.block.train(was_training)
        params = [p for _, p in self._trainable]
        with torch.no_grad():
            # the loss is the MEAN over the batch, so its gradients are
            # already batch-normalised: rescale stays 1
            new_p, self._opt_state = self.optimizer.apply(
                [p.detach() for p in params], grads, self._opt_state, lr, t,
                self._wd_mults, self._lr_mults, 1.0)
            for p, w in zip(params, new_p):
                p.copy_(w)
        return loss

    def sync_params(self):
        """A no-op: ``step`` updates the module's own parameters in place,
        so they always hold the trained values (the JAX trainer keeps them
        on the mesh and writes them back here)."""

    def state_dict(self, copy=True):
        """The full train state (parameters, optimizer states, aux state,
        step) as a pytree, valid after the first step: a host snapshot,
        or with ``copy=False`` the live tensors for
        ``AsyncCheckpointer.save`` (``checkpoint.trainer_state``).  The
        ``resilience.run_resilient`` ``get_state`` hook."""
        from .. import checkpoint

        return checkpoint.trainer_state(self, copy=copy)

    def load_state_dict(self, state):
        """Load a ``state_dict()`` or checkpoint pytree back into this
        trainer's tensors, bitwise (the ``set_state`` hook)."""
        from .. import checkpoint

        checkpoint.load_trainer_state(self, state)

    def state_template(self):
        """The restore template: ``state_dict()``'s structure with this
        trainer's device at every tensor position."""
        from .. import checkpoint

        return checkpoint.trainer_state_template(self)

    @property
    def learning_rate(self):
        return self.optimizer.lr_at(self._num_update)

    def set_learning_rate(self, lr):
        self.optimizer.lr = lr
        self.optimizer.lr_scheduler = None


class DataParallelTrainer(ShardedTrainer):
    """The common case, pure data parallelism; one device here."""

    def __init__(self, block, loss_fn, optimizer="sgd",
                 optimizer_params=None, n_devices=None):
        if n_devices not in (None, 1):
            raise NotImplementedError("DataParallelTrainer: more than one "
                                      "device is not ported yet")
        super().__init__(block, loss_fn, optimizer, optimizer_params)
