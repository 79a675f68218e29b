"""Numerical-health guard: finite checks, skip-step, clipping and
divergence monitoring.

Counterpart of ``mxnet_tpu/numerics.py``.  One NaN/Inf gradient silently
corrupts optimizer state and every later step.  The guard stays on the
device:

- ``grad_health(tensors)``: one ``torch._foreach_norm`` pass (f32
  accumulation) over the step's gradients, returning a ``(2,)`` f32 device
  tensor ``[all_finite, global_sq_norm]``; no host sync;
- ``StepGuard`` carries it into the grouped update
  (``optimizer/grouped.py``), which selects between the new and the old
  weights and states with ``torch.where``: an unhealthy step leaves them
  bitwise unchanged;
- exactly ONE host readback a step: the Trainer reads the health once,
  AFTER the update (``readback_count`` counts them);
- ``DivergenceMonitor``: host-side EWMA tracking of loss and gradient
  norm; after ``MXTPU_MAX_BAD_STEPS`` consecutive bad steps it rolls back
  to the newest valid checkpoint, reseeds the loss scale, quarantines the
  streak's batches and rewinds an attached input pipeline, or, without a
  checkpointer, raises ``DivergenceError``.

Env knobs, as the JAX package's: ``MXTPU_GRAD_GUARD`` (default 1),
``MXTPU_MAX_BAD_STEPS`` (default 25), ``MXTPU_CLIP_GLOBAL_NORM`` (unset =
no clipping).  Fault sites: ``nan_grad`` poisons one gradient before the
health reduction; ``inf_loss`` corrupts the loss
``DivergenceMonitor.observe`` sees.
"""

from __future__ import annotations

import logging
import math
import os

import torch

from .base import MXNetError

_LOG = logging.getLogger("mxnet_tpu_torch.numerics")


# -- env plumbing --------------------------------------------------------------

def grad_guard_enabled() -> bool:
    """MXTPU_GRAD_GUARD gate (default on); 0/false/off disables the
    finite-check and skip-step machinery.  Read at each step."""
    return os.environ.get("MXTPU_GRAD_GUARD", "1").lower() \
        not in ("0", "false", "off", "")


def max_bad_steps(default=25) -> int:
    """MXTPU_MAX_BAD_STEPS: consecutive unhealthy or exploding steps before
    ``DivergenceMonitor`` declares divergence."""
    try:
        return int(os.environ.get("MXTPU_MAX_BAD_STEPS", default))
    except ValueError:
        return default


def clip_global_norm_env():
    """MXTPU_CLIP_GLOBAL_NORM as a float, or None when unset or <= 0."""
    raw = os.environ.get("MXTPU_CLIP_GLOBAL_NORM")
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0.0 else None


# -- readback accounting -------------------------------------------------------

_READBACK_COUNT = 0


def readback_count() -> int:
    """Health readbacks to the host since the last reset: one per guarded
    step (the ``StepGuard`` materialisation)."""
    return _READBACK_COUNT


def reset_readback_count() -> None:
    global _READBACK_COUNT
    _READBACK_COUNT = 0


# -- the health reduction ------------------------------------------------------

def health_of(tensors):
    """``(2,)`` f32 ``[all_finite, global_sq_norm]`` of ``tensors`` on
    their device (f64 when one of them is f64), the one home of the health
    math (the eager guard and the captured step both call it).  Each
    tensor's L2 norm accumulates in that dtype; a non-finite element makes
    its norm non-finite, and so the predicate ``all_finite > 0 and
    isfinite(sq)`` false, as the reference's elementwise check does."""
    tensors = list(tensors)
    acc = torch.float64 if any(t.dtype == torch.float64 for t in tensors) \
        else torch.float32
    norms = torch.stack(torch._foreach_norm(tensors, 2, dtype=acc))
    fin = torch.isfinite(norms).all()
    return torch.stack([fin.to(acc), (norms * norms).sum()])


def grad_health(tensors):
    """``health_of`` over the step's gradients; nothing is read back."""
    return health_of(tensors)


def combine_health(parts):
    """Fold per-bucket ``(2,)`` health partials into one, on the device."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    stacked = torch.stack(parts)
    return torch.stack([stacked[:, 0].min(), stacked[:, 1].sum()])


class StepGuard:
    """Per-step carrier of the device health tensor.

    ``skip`` enables skip-step semantics (``torch.where`` in the grouped
    update, and a host-side skip of the legacy-loop items); ``clip`` scales
    the gradients by the global-norm clip coefficient inside the update.
    ``extra`` is the integrity fingerprint (a ``(2,)`` int64 device tensor)
    on an attestation step: it rides the same readback.  The host readback
    happens at most once, lazily, and is counted."""

    def __init__(self, health, skip=True, clip=None, extra=None):
        self.health = health
        self.skip = bool(skip)
        self.clip = None if clip is None else float(clip)
        self.extra = extra
        self._host = None
        self._extra_host = None

    def _materialize(self):
        if self._host is None:
            global _READBACK_COUNT
            _READBACK_COUNT += 1
            from . import profiler

            # the step's one host sync: the fingerprint (words below
            # 2^32, exact in f64) rides the same transfer
            with profiler.annotate("guard_readback"):
                if self.extra is not None:
                    v = torch.cat([self.health.detach().double(),
                                   self.extra.detach().double()]) \
                        .cpu().tolist()
                    self._extra_host = (int(v[2]), int(v[3]))
                else:
                    v = self.health.detach().cpu().tolist()
            self._host = (float(v[0]), float(v[1]))
        return self._host

    @property
    def fingerprint(self):
        """The step's integrity fingerprint as one u64, or None when the
        step computed none (integrity off, or not an attestation step).
        Shares the one guard readback."""
        if self.extra is None:
            return None
        self._materialize()
        lo, hi = self._extra_host
        return (hi << 32) | lo

    def peek(self):
        """``(all_finite, global_sq_norm)`` if read back already, else
        None: never forces a sync."""
        return self._host

    @property
    def healthy(self) -> bool:
        """Every gradient finite AND the global squared norm finite."""
        fin, sq = self._materialize()
        return fin > 0.0 and math.isfinite(sq)

    @property
    def grad_norm(self) -> float:
        """Global L2 norm of the step's gradients (host value)."""
        _, sq = self._materialize()
        return math.sqrt(sq) if sq >= 0.0 else float("nan")


class StepSkipped:
    """Record of one skipped optimizer step (``Trainer.skipped_steps``)."""

    __slots__ = ("step", "reason", "grad_norm", "loss_scale")

    def __init__(self, step, reason, grad_norm=None, loss_scale=None):
        self.step = step
        self.reason = reason
        self.grad_norm = grad_norm
        self.loss_scale = loss_scale

    def __repr__(self):
        extra = ""
        if self.grad_norm is not None:
            extra += f", grad_norm={self.grad_norm:g}"
        if self.loss_scale is not None:
            extra += f", loss_scale={self.loss_scale:g}"
        return f"StepSkipped(step={self.step}, reason={self.reason!r}{extra})"


def maybe_inject_nan_grad(grads) -> bool:
    """The ``nan_grad`` fault site: poison element 0 of the first float
    gradient with NaN, in place (the health reduction and the update
    kernels then see the same poisoned value).  Consumes one armed count
    a call; returns True when it fired."""
    from . import resilience

    if not grads or not resilience.consume_fault("nan_grad"):
        return False
    for g in grads:
        t = getattr(g, "_data", g)
        if getattr(g, "stype", "default") != "default" or \
                not isinstance(t, torch.Tensor) or \
                not t.is_floating_point() or t.numel() == 0:
            continue
        t.detach().view(-1)[0] = float("nan")
        _LOG.warning("fault injection: poisoned gradient with NaN "
                     "(MXTPU_FAULT_INJECT nan_grad)")
        return True
    return False


# -- divergence monitoring -----------------------------------------------------

class DivergenceError(MXNetError):
    """Training diverged and no checkpointer was attached for rollback.

    Carries the failing window so the caller can triage (same spirit as
    `gluon.data.DataLoaderWorkerError` surfacing the failing batch):
    ``bad_steps`` (length of the unhealthy streak), ``step`` (last
    observed step), ``batch_indices`` (quarantined sample/batch indices
    seen during the streak, if the caller supplied them).
    """

    def __init__(self, msg, step=None, bad_steps=None, batch_indices=None):
        super().__init__(msg)
        self.step = step
        self.bad_steps = bad_steps
        self.batch_indices = list(batch_indices or [])


class DivergenceMonitor:
    """EWMA-based divergence detector with checkpoint auto-rollback.

    Feed it one `observe()` per step — either attach it to a Trainer
    (``trainer.divergence_monitor = mon``; the Trainer then calls
    ``observe(healthy=..., grad_norm=...)`` from the guarded step) or
    drive it manually with the loss.  Do NOT do both, or each training
    step counts as two observations.

    A step is **bad** when it is unhealthy (non-finite grads/loss) or
    when grad-norm/loss explodes past ``explode_factor`` × its EWMA.
    After ``max_bad_steps`` consecutive bad steps (MXTPU_MAX_BAD_STEPS):

    - with a ``checkpointer`` + ``set_state``: roll back to the newest
      valid `resilience.LocalCheckpointer` snapshot, re-seed the loss
      scale (``reseed_scale`` or current/scale_factor), quarantine the
      batch indices observed during the streak, and return True;
    - without one: raise `DivergenceError` carrying the streak context.
    """

    def __init__(self, checkpointer=None, set_state=None, scaler=None,
                 max_bad_steps=None, ewma_alpha=0.05, explode_factor=8.0,
                 reseed_scale=None, logger=None):
        self.checkpointer = checkpointer
        self.set_state = set_state
        self.scaler = scaler
        self.max_bad_steps = int(max_bad_steps) if max_bad_steps \
            else globals()["max_bad_steps"]()
        self.ewma_alpha = float(ewma_alpha)
        self.explode_factor = float(explode_factor)
        self.reseed_scale = reseed_scale
        self.logger = logger or _LOG
        self.loss_ewma = None
        self.norm_ewma = None
        self.bad_streak = 0
        self.recoveries = 0
        self.quarantined = []
        self._streak_batches = []
        self._last_step = None
        # optional resumable input pipeline (an object with
        # load_state_dict/quarantine, e.g. gluon.data.DataLoader built
        # with seed=): rollback rewinds it to the restored checkpoint's
        # sample offset and quarantines the streak's batches so replay
        # skips them (one `batch_quarantined` event per skip)
        self.data_pipeline = None

    def _is_bad(self, loss, grad_norm, healthy):
        if not healthy:
            return True
        if loss is not None and not math.isfinite(loss):
            return True
        if grad_norm is not None and not math.isfinite(grad_norm):
            return True
        if grad_norm is not None and self.norm_ewma is not None \
                and self.norm_ewma > 0.0 \
                and grad_norm > self.explode_factor * self.norm_ewma:
            return True
        if loss is not None and self.loss_ewma is not None \
                and abs(loss) > self.explode_factor \
                * max(abs(self.loss_ewma), 1e-8):
            return True
        return False

    def observe(self, step=None, loss=None, grad_norm=None, healthy=True,
                batch_indices=None) -> bool:
        """Record one training step; returns True iff a rollback ran."""
        from . import resilience

        if resilience.consume_fault("inf_loss"):
            loss = float("inf")
        self._last_step = step if step is not None else \
            (self._last_step + 1 if self._last_step is not None else 0)
        if self._is_bad(loss, grad_norm, healthy):
            self.bad_streak += 1
            if batch_indices is not None:
                self._streak_batches.extend(
                    batch_indices if isinstance(batch_indices, (list, tuple))
                    else [batch_indices])
            if self.bad_streak >= self.max_bad_steps:
                return self._recover()
            return False
        self.bad_streak = 0
        self._streak_batches = []
        a = self.ewma_alpha
        if loss is not None:
            self.loss_ewma = loss if self.loss_ewma is None \
                else (1.0 - a) * self.loss_ewma + a * loss
        if grad_norm is not None:
            self.norm_ewma = grad_norm if self.norm_ewma is None \
                else (1.0 - a) * self.norm_ewma + a * grad_norm
        return False

    def _recover(self) -> bool:
        from . import resilience

        bad, step = self.bad_streak, self._last_step
        self.quarantined.extend(self._streak_batches)
        batches = list(self._streak_batches)
        self._streak_batches = []
        self.bad_streak = 0
        restored = 0
        if self.checkpointer is not None and self.set_state is not None:
            restored = resilience.resume_latest(
                self.checkpointer, self.set_state, logger=self.logger)
        if self.checkpointer is None or self.set_state is None \
                or (restored == 0
                    and not getattr(self.checkpointer, "all_steps",
                                    lambda: [])()):
            raise DivergenceError(
                f"training diverged: {bad} consecutive unhealthy/exploding "
                f"steps (last step {step}; loss ewma "
                f"{self.loss_ewma}, grad-norm ewma {self.norm_ewma}); "
                f"quarantined batch indices: {batches or 'none supplied'}. "
                "Attach a resilience.LocalCheckpointer for auto-rollback, "
                "or lower the learning rate / re-seed the loss scale.",
                step=step, bad_steps=bad, batch_indices=batches)
        if self.scaler is not None:
            if self.reseed_scale is not None:
                self.scaler.loss_scale = float(self.reseed_scale)
            else:
                self.scaler.loss_scale = max(
                    1.0, self.scaler.loss_scale / self.scaler.scale_factor)
            self.scaler._unskipped = 0
        if self.data_pipeline is not None:
            ds_fn = getattr(self.checkpointer, "data_state", None)
            ds = ds_fn(restored) if ds_fn is not None else None
            if ds is not None:
                # rewind the pipeline to the checkpoint's exact sample
                # offset FIRST (load replaces the quarantine set), then
                # quarantine the streak so replay skips the poison
                self.data_pipeline.load_state_dict(ds)
            bad_ids = [tuple(b) for b in batches
                       if isinstance(b, (list, tuple)) and len(b) == 2]
            if bad_ids:
                self.data_pipeline.quarantine(bad_ids)
        self.recoveries += 1
        self.logger.warning(
            "divergence auto-recovery #%d: rolled back to checkpoint step "
            "%d after %d bad steps; quarantined batches: %s",
            self.recoveries, restored, bad, batches or "none supplied")
        from . import telemetry
        telemetry.event("divergence_rollback", step=restored,
                        bad_steps=bad, last_step=step,
                        quarantined=len(batches))
        return True
