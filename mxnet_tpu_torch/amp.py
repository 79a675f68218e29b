"""Automatic mixed precision.

Counterpart of ``mxnet_tpu/amp.py`` (reference: python/mxnet/contrib/amp).
The default policy is bfloat16, which needs no loss scaling (the exponent
range of f32): ``init()`` records it, ``convert_block`` casts a block, and
``init_trainer`` gives the optimizer f32 master weights
(``multi_precision``) and ``convert_model`` casts a symbolic model's
parameters.  A float16 policy with ``DynamicLossScaler`` is
provided as well; the Trainer folds the scaler's ``1 / loss_scale`` into
``rescale_grad`` and its guarded step halves the scale on an overflow.
"""

from __future__ import annotations

import contextlib

_STATE = {"initialized": False, "dtype": "bfloat16"}


def init(target_dtype="bfloat16"):
    """Enable AMP defaults (reference: amp.init): records the policy;
    casting happens per model through ``convert_block``."""
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError(f"amp.init: target_dtype must be bfloat16 or "
                         f"float16, got {target_dtype!r}")
    _STATE["initialized"] = True
    _STATE["dtype"] = target_dtype


def init_trainer(trainer):
    """Switch a Trainer's optimizer to multi-precision master weights
    (reference: amp.init_trainer)."""
    trainer._optimizer.multi_precision = True
    return trainer


def convert_block(block, target_dtype=None):
    """Cast a Gluon block to the AMP dtype (reference: amp.convert_block)."""
    block.cast(target_dtype or _STATE["dtype"])
    return block


init_block = convert_block


def convert_model(sym, arg_params, aux_params, target_dtype=None):
    """The symbol path's conversion (reference: amp.convert_model): the
    parameters cast to the AMP dtype; the graph computes in its
    parameters' dtype, so ``sym`` is returned as it is."""
    target_dtype = target_dtype or _STATE["dtype"]
    cast = {k: v.astype(target_dtype) for k, v in arg_params.items()}
    aux = {k: v.astype(target_dtype) for k, v in aux_params.items()}
    return sym, cast, aux


class DynamicLossScaler:
    """Loss scaling for float16 training (reference: the AMP loss scaler;
    unnecessary under bfloat16).

    ``tolerance`` is the fraction of overflowed steps since the last
    rescale at which an overflow halves the scale (0.0: every overflow
    halves).  Growth doubles after ``scale_window`` clean steps, capped at
    ``max(init_scale, 2**16)``."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        self.loss_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.tolerance = tolerance
        self._max_scale = max(init_scale, 2.0 ** 16)
        self._unskipped = 0
        self._iter = 0
        self._last_rescale_iter = 0
        self._overflows_since_rescale = 0

    def scale(self, loss):
        return loss * self.loss_scale

    def unscale(self, grads):
        """The gradients divided by the current scale, as new arrays (the
        Trainer does not need this: it folds ``1/loss_scale`` into
        ``rescale_grad``)."""
        inv = 1.0 / self.loss_scale
        return [g * inv for g in grads]

    def has_overflow(self, grads):
        """One device reduction and one host readback over all
        gradients."""
        from . import numerics

        raws = [getattr(g, "_data", g) for g in grads]
        if not raws:
            return False
        return not numerics.StepGuard(numerics.grad_health(raws)).healthy

    def update_scale(self, overflow):
        """Halve on an overflow (subject to ``tolerance``); double after
        ``scale_window`` clean steps, capped."""
        self._iter += 1
        if overflow:
            self._overflows_since_rescale += 1
            pct = self._overflows_since_rescale / \
                max(1, self._iter - self._last_rescale_iter)
            if pct >= self.tolerance:
                self.loss_scale = max(
                    self.loss_scale / self.scale_factor, 1.0)
                self._last_rescale_iter = self._iter
                self._overflows_since_rescale = 0
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self.loss_scale = min(self.loss_scale * self.scale_factor,
                                      self._max_scale)
                self._last_rescale_iter = self._iter
                self._overflows_since_rescale = 0
                self._unskipped = 0
        return self.loss_scale


def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled:`` (reference):
    bfloat16 yields the loss as it is; float16 yields it times the
    trainer's loss scale (creating its ``DynamicLossScaler``)."""

    @contextlib.contextmanager
    def ctx():
        if _STATE["dtype"] == "bfloat16":
            yield loss
        else:
            scaler = getattr(trainer, "_amp_loss_scaler", None)
            if scaler is None:
                scaler = DynamicLossScaler()
                trainer._amp_loss_scaler = scaler
            trainer._scale = 1.0 / scaler.loss_scale
            yield loss * scaler.loss_scale
    return ctx()
