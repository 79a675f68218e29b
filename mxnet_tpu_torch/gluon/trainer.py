"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py): ``Trainer(params, optimizer,
optimizer_params, kvstore, update_on_kvstore)``, ``step``/
``allreduce_grads``/``update``, learning-rate control, ``train_step``
(whole-step capture, ``gluon.captured``) and the optimizer-state
save/load, in the reference's order of operations.

On one worker a 'local', 'device' or 'nccl' kvstore takes the local path
(no store), whose update is the grouped multi-tensor one
(``optimizer.GroupedUpdater``), guarded by ``numerics.StepGuard`` unless
``MXTPU_GRAD_GUARD=0``; ``MXTPU_FUSED_STEP=0`` restores the legacy
per-parameter loop.  Row-sparse gradients stay compact all the way: the
health reads their stored rows and the update touches only those rows.
A row-sparse model that ``train_step`` cannot capture emits a
``sparse_fallback{reason}`` telemetry event before it runs eagerly.
``step`` refuses a gradient that no ``backward`` has written since the
last step, unless ``ignore_stale_grad``.
``attach_data_pipeline`` takes a resumable input pipeline: each guarded
step hands the divergence monitor the id of the batch just delivered,
and the monitor's rollback rewinds the pipeline.  ``step`` and
``train_step`` emit one telemetry step record each (path, breakdown,
grad norm, loss scale, samples seen; FLOPs, MFU and peak memory on the
captured path).  ``attach_integrity`` attaches an
``integrity.IntegrityPlane``: the captured step fingerprints the state
on due steps and the trainer attests it.  The ``nan_grad`` and
``bit_flip_grad`` fault sites poison a gradient before the health
reduction; an armed site routes ``train_step`` to the eager path, where
the gradient lives in a buffer.  ``train_step`` consults ``autotune``
once per capture signature before its capture lookup
(``MXTPU_AUTOTUNE=replay|search|off``).

A dist store ('dist_sync', 'dist_device_sync', 'dist_async') always goes
through the store (``kvstore_requires_store``), as the reference's does:
with ``update_on_kvstore`` (the default there) each gradient is pushed,
all-reduced across the workers and applied by the store's updater, and
the weight pulled back; without it ``bucketed_pushpull`` all-reduces the
gradients and the grouped update runs here.  ``compression_params``
turns on the store's gradient compression.  Such a trainer takes the
eager path (``kvstore.captured_step_compatible``).  Parameters placed as
DTensors by ``parallel.shard_model`` on a rank mesh train through
``parallel.ShardedTrainer``; this trainer refuses them (ROADMAP queue 1
item 1b).
"""

from __future__ import annotations

import logging

import torch

from .. import numerics
from .. import optimizer as opt
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

_LOG = logging.getLogger("mxnet_tpu_torch.gluon.trainer")

_MAX_SKIP_RECORDS = 1000


def _health_tensor(grad):
    """The tensor a gradient's health reads.  A row-sparse gradient's
    stored rows, never its dense view: padded with zero rows to its
    unique-count bucket when it has one, the shape the captured step's
    gradient rows have, so both paths reduce the same tensor."""
    if grad.stype != "row_sparse":
        return grad._data
    from ..embedding.prep import bucket_for

    vals = grad._rs_values
    bucket = bucket_for(vals.shape[0])
    if bucket is None or bucket <= vals.shape[0]:
        return vals
    pad = vals.new_zeros((bucket - vals.shape[0],) + tuple(vals.shape[1:]))
    return torch.cat([vals, pad])


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    gluon.Trainer)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, clip_global_norm=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._params.append(param)
        self._compression_params = compression_params
        from .. import obs

        obs.ensure_from_env()          # MXTPU_METRICS_PORT, if set
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._clip_global_norm = None if clip_global_norm is None \
            else float(clip_global_norm)
        self.divergence_monitor = None
        self._data_pipeline = None
        self._integrity_plane = None
        self.skipped_steps = []
        self._step_count = 0

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an " \
                "Optimizer instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]
        # the multi-tensor path shares each Updater's state dict, so
        # save/load_states round-trip whichever path stepped
        self._grouped_updaters = [opt.GroupedUpdater(u)
                                  for u in self._updaters]

    def _init_kvstore(self):
        """A store of one worker is no store: the local path, the reduce
        of one copy being the copy.  A dist type always keeps its store
        (``kvstore_requires_store``); ``update_on_kvstore`` defaults to
        True there, as in the reference."""
        for p in self._params:
            if _is_dtensor(p):
                raise NotImplementedError(
                    f"Trainer: parameter {p.name!r} is a DTensor placed by "
                    "parallel.shard_model on a rank mesh; train it with "
                    "parallel.ShardedTrainer (gluon.Trainer and the "
                    "captured train_step over a rank mesh wait for the "
                    "next multi-GPU slice, ROADMAP queue 1 item 1b)")
        config = self._kvstore_params
        kvstore = config["kvstore"]
        update_on_kvstore = config["update_on_kvstore"]
        kv = None
        if kvstore:
            from .. import kvstore as kvs

            kv = kvs.create(kvstore) if isinstance(kvstore, str) else kvstore
            if kv.num_workers == 1 and not kvstore_requires_store(kv):
                kv = None
        if kv is not None:
            if self._compression_params is not None:
                kv.set_gradient_compression(self._compression_params)
            if update_on_kvstore is None:
                update_on_kvstore = True
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    kv.init(i, param.data())
        self._kvstore = kv
        self._update_on_kvstore = bool(update_on_kvstore) and kv is not None
        self._kv_initialized = True

    @property
    def learning_rate(self):
        if not isinstance(self._optimizer, opt.Optimizer):
            raise UserWarning("Optimizer has to be defined before its "
                              "learning rate can be accessed.")
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        if not isinstance(self._optimizer, opt.Optimizer):
            raise UserWarning("Optimizer has to be defined before its "
                              "learning rate is mutated.")
        self._optimizer.set_learning_rate(lr)

    def _clip_norm(self):
        return self._clip_global_norm \
            if self._clip_global_norm is not None \
            else numerics.clip_global_norm_env()

    def _set_rescale(self, batch_size):
        # amp: the loss scaler's unscale folds into rescale_grad, so the
        # division happens inside the update
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            self._scale = 1.0 / scaler.loss_scale
        self._optimizer.rescale_grad = self._scale / batch_size

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce_grads + update (reference: Trainer.step)."""
        from .. import telemetry

        # None when train_step already opened the record
        acc = telemetry.step_begin(path="manual")
        n_skipped = len(self.skipped_steps)
        try:
            if not self._kv_initialized:
                self._init_kvstore()
            self._set_rescale(batch_size)
            health = self._allreduce_grads()
            self._update(ignore_stale_grad, health=health)
        except BaseException:
            telemetry.step_abort(acc)
            raise
        telemetry.step_end(acc, step=self._step_count,
                           skipped=len(self.skipped_steps) > n_skipped)

    def train_step(self, block, loss_fn, data, label=None, batch_size=None,
                   grad_accum=1, ignore_stale_grad=False):
        """One full training step: forward, loss, backward, gradient
        accumulation over ``grad_accum`` microbatches, health guard, clip
        and optimizer update; returns the loss (stacked per microbatch
        when ``grad_accum > 1``).

        When the configuration can be captured (a hybridized block, an
        optimizer with a grouped plan, the local path; see
        ``gluon.captured``) the whole step runs as one captured step: one
        CUDA graph replay on the card, with one host readback after the
        update.  Otherwise, or under ``MXTPU_CAPTURED_STEP=0``, it runs the
        eager path, which is the captured step's bitwise oracle.  The
        captured step never writes the parameters' gradient buffers."""
        from .. import resilience
        from .. import telemetry
        from . import captured as _captured

        if not self._kv_initialized:
            self._init_kvstore()
        if batch_size is None:
            batch_size = data.shape[0]
        # autotune consult: replay a stored winner, or search the knob
        # space, once per capture signature, before this step's capture
        # lookup reads the knobs
        from .. import autotune as _autotune

        k = _autotune.maybe_tune(self, block, loss_fn, data, label,
                                 int(grad_accum))
        acc = telemetry.step_begin()
        n_skipped = len(self.skipped_steps)
        step = None
        try:
            # a pending nan_grad / bit_flip_grad injection needs a
            # gradient buffer to land in: that step runs eagerly
            if _captured.captured_step_enabled() \
                    and not resilience.fault_armed("nan_grad") \
                    and not resilience.fault_armed("bit_flip_grad"):
                hits0 = _captured.cache_stats()["hits"] if acc else 0
                step = _captured.get_step(self, block, loss_fn, data,
                                          label, k)
                if step is not None and acc is not None:
                    telemetry.note_path("captured")
                    telemetry.note(
                        cache_hit=_captured.cache_stats()["hits"] > hits0)
            if step is not None:
                result = step(self, data, label, batch_size)
                if acc is not None:
                    telemetry.note(flops=step.cost_flops())
                    peak = step.memory_high_water()
                    if peak is not None:
                        telemetry.note(device_peak_bytes=peak)
            else:
                self._note_sparse_fallback(block, loss_fn, data, k)
                result = self._eager_train_step(block, loss_fn, data, label,
                                                batch_size, k,
                                                ignore_stale_grad)
        except BaseException:
            telemetry.step_abort(acc)
            raise
        telemetry.step_end(acc, step=self._step_count,
                           skipped=len(self.skipped_steps) > n_skipped)
        return result

    def _note_sparse_fallback(self, block, loss_fn, data, grad_accum):
        """A row-sparse model on the eager oracle is a performance cliff
        (one dispatch an op, the host's coalesce) its user meant to
        avoid: emit ``sparse_fallback{reason}`` instead of degrading
        silently.  Dense models fall back silently."""
        from .. import resilience
        from .. import telemetry
        from . import captured as _captured

        if not _captured.sparse_params(self):
            return
        if not _captured.captured_step_enabled():
            reason = "captured step disabled (MXTPU_CAPTURED_STEP=0)"
        elif resilience.fault_armed("nan_grad") \
                or resilience.fault_armed("bit_flip_grad"):
            reason = "pending gradient fault injection"
        else:
            reason = getattr(self, "_sparse_fallback_reason", None)
            self._sparse_fallback_reason = None
            if reason is None:
                reason = _captured.ineligible_reason(
                    self, block, loss_fn, data, grad_accum) \
                    or "capture declined"
        telemetry.event("sparse_fallback", reason=reason)

    def _eager_train_step(self, block, loss_fn, data, label, batch_size,
                          grad_accum, ignore_stale_grad):
        """The step the captured one is checked against: per-microbatch
        forward and backward into the gradient buffers, then ``step``."""
        from .. import autograd as ag
        from . import captured as _captured

        scaler = getattr(self, "_amp_loss_scaler", None)
        k = grad_accum
        if k == 1:
            with ag.record():
                out = block(data)
                loss = loss_fn(out, label) if label is not None \
                    else loss_fn(out)
                scaled = loss * scaler.loss_scale \
                    if scaler is not None else loss
            scaled.backward()
            result = loss
        else:
            if data.shape[0] % k:
                raise ValueError(
                    f"batch size {data.shape[0]} is not divisible by "
                    f"grad_accum {k}")
            m = data.shape[0] // k
            params = [p for p in self._params if p.grad_req != "null"]
            losses = []
            with ag.accumulate_grads(params):
                for j in range(k):
                    xs = data[j * m:(j + 1) * m]
                    ys = None if label is None \
                        else _captured._slice(label, j * m, (j + 1) * m)
                    with ag.record():
                        out = block(xs)
                        loss = loss_fn(out, ys) if ys is not None \
                            else loss_fn(out)
                        scaled = loss * scaler.loss_scale \
                            if scaler is not None else loss
                    scaled.backward()
                    losses.append(loss)
            result = NDArray(torch.stack([l._data for l in losses]),
                             losses[0]._ctx)
        self.step(batch_size, ignore_stale_grad)
        return result

    def allreduce_grads(self):
        """Reduce the gradients across workers (nothing to do on one)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise AssertionError(
                "allreduce_grads() when parameters are updated on kvstore "
                "is not supported. Try setting `update_on_kvstore` to False "
                "when creating trainer.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        """The cross-worker gradient reduce.  Returns the fused ``(2,)``
        health tensor when ``bucketed_pushpull`` computed it after the
        reduce, else None (the guarded update takes its own)."""
        if self._kvstore is None:
            return None
        if self._update_on_kvstore:
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.push(i, param.list_grad(), priority=-i)
            return None
        keys = [i for i, param in enumerate(self._params)
                if param.grad_req != "null"]
        if opt.grouped.fused_step_enabled():
            grads = [self._params[i].list_grad() for i in keys]
            want = numerics.grad_guard_enabled() \
                or self._clip_norm() is not None
            return self._kvstore.bucketed_pushpull(keys, grads, outs=grads,
                                                   health=want)
        for i in keys:
            self._kvstore.pushpull(i, self._params[i].list_grad(),
                                   out=self._params[i].list_grad(),
                                   priority=-i)
        return None

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise AssertionError(
                "update() when parameters are updated on kvstore is not "
                "supported. Try setting `update_on_kvstore` to False when "
                "creating trainer.")
        self._set_rescale(batch_size)
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False, health=None):
        updates = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            data = param.data()
            if not ignore_stale_grad and not data._fresh_grad:
                raise UserWarning(
                    f"Gradient of Parameter `{param.name}` on context "
                    f"{data.context} has not been updated by backward "
                    "since last `step`. This could mean a bug in your "
                    "model that made it only use a subset of the "
                    "Parameters (Blocks) for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning and "
                    "skip updating of Parameters with stale gradient")
            data._fresh_grad = False
            if self._update_on_kvstore:
                self._kvstore.pull(i, param.list_data(), priority=-i)
            else:
                updates.append((i, param.grad(), data))
        self._step_count += 1
        if not updates:
            return
        indices, grads, weights = map(list, zip(*updates))
        fused = opt.grouped.fused_step_enabled()
        guard_on = numerics.grad_guard_enabled()
        clip = self._clip_norm()
        if fused and (guard_on or clip is not None):
            # the nan_grad / bit_flip_grad fault sites
            from .. import integrity as _integrity

            flipped = _integrity.maybe_bit_flip_grad(grads=grads)
            if numerics.maybe_inject_nan_grad(grads) or flipped \
                    or health is None:
                health = numerics.grad_health(
                    [_health_tensor(g) for g in grads])
            guard = numerics.StepGuard(health, skip=guard_on, clip=clip)
            snapshot = self._snapshot_update_counts(indices) \
                if guard_on else None
            self._grouped_updaters[0](indices, grads, weights, guard=guard)
            self._finalize_guarded_step(guard, snapshot)
        elif fused:
            self._grouped_updaters[0](indices, grads, weights)
        else:
            for i, g, w in updates:
                self._updaters[0](i, g, w)

    def attach_data_pipeline(self, pipeline):
        """Attach a resumable input pipeline (a ``DataLoader`` built with
        ``seed=``, or a ``DevicePrefetcher`` wrapping one).  The guarded
        step then (a) passes the just-delivered batch id to the
        divergence monitor, whose rollback quarantines the streak's
        batches so the replay skips them, and (b) notes ``samples_seen``
        on each step record.  An attached ``divergence_monitor``'s
        rollback also rewinds the pipeline to the restored checkpoint's
        sample offset.  Returns self."""
        self._data_pipeline = pipeline
        if self.divergence_monitor is not None:
            self.divergence_monitor.data_pipeline = pipeline
        return self

    def _batch_ids(self):
        """[(epoch, batch_idx)] of the last-delivered batch, or None."""
        p = self._data_pipeline
        if p is None:
            return None
        bid = p.last_batch_id()
        return None if bid is None else [bid]

    # -- integrity plane plumbing (integrity.py) -------------------------------

    def attach_integrity(self, plane):
        """Attach an ``integrity.IntegrityPlane``: with MXTPU_INTEGRITY on,
        the captured step fingerprints the parameters and optimizer
        states every ``plane.every`` steps (read back with the step
        guard's one readback) and attests them against the plane's
        peers.  Returns self."""
        self._integrity_plane = plane
        return self

    def _integrity_due(self):
        """Does the step about to run attest?"""
        plane = self._integrity_plane
        return plane is not None and plane.due(self._step_count + 1)

    def _integrity_attest(self, fp):
        """One attestation round for the step that just committed."""
        plane = self._integrity_plane
        if plane is None or fp is None:
            return None
        return plane.attest(self._step_count, fp)

    # -- numerical-health guard plumbing (numerics.py) -------------------------

    def _snapshot_update_counts(self, indices):
        """The optimizer's step counters before the guarded update bumps
        them: a skipped step leaves Adam's ``t`` (and the rest) as if the
        bad batch never came."""
        o = self._optimizer
        return (o.num_update,
                {i: o._index_update_count.get(i) for i in indices})

    def _restore_update_counts(self, snapshot):
        o = self._optimizer
        num_update, per_index = snapshot
        o.num_update = num_update
        for i, v in per_index.items():
            if v is None:
                o._index_update_count.pop(i, None)
            else:
                o._index_update_count[i] = v

    def _finalize_guarded_step(self, guard, snapshot):
        """The step's ONE host readback, after the update: on an unhealthy
        step the update already kept the weights and states; this rolls
        back the step counters, halves the amp loss scale, records a
        ``StepSkipped``, notes the guard's scalars on the step record and
        attests the fingerprint the readback brought."""
        from .. import telemetry

        scaler = getattr(self, "_amp_loss_scaler", None)
        monitor = self.divergence_monitor
        if not guard.skip:
            if monitor is not None:
                monitor.observe(step=self._step_count,
                                grad_norm=guard.grad_norm, healthy=True,
                                batch_indices=self._batch_ids())
            self._note_guard_scalars(guard, scaler)
            self._integrity_attest(guard.fingerprint)
            return
        healthy = guard.healthy
        if not healthy:
            self._restore_update_counts(snapshot)
            rec = numerics.StepSkipped(
                step=self._step_count, reason="non-finite gradients",
                grad_norm=guard.grad_norm,
                loss_scale=scaler.loss_scale if scaler else None)
            self.skipped_steps.append(rec)
            del self.skipped_steps[:-_MAX_SKIP_RECORDS]
            _LOG.warning("skipped optimizer step: %r", rec)
            telemetry.count("step.skipped")
            telemetry.event("step_skipped", step=rec.step,
                            reason=rec.reason, grad_norm=rec.grad_norm,
                            loss_scale=rec.loss_scale)
        if scaler is not None:
            scaler.update_scale(not healthy)
            self._scale = 1.0 / scaler.loss_scale
        if monitor is not None:
            monitor.observe(step=self._step_count,
                            grad_norm=guard.grad_norm, healthy=healthy,
                            batch_indices=self._batch_ids())
        self._note_guard_scalars(guard, scaler)
        self._integrity_attest(guard.fingerprint)

    def _note_guard_scalars(self, guard, scaler):
        """The guard's scalars on the open step record, read only through
        ``StepGuard.peek()``: telemetry never adds a readback."""
        import math

        from .. import telemetry

        host = guard.peek()
        if host is not None:
            _, sq = host
            telemetry.note(grad_norm=math.sqrt(sq) if sq >= 0.0
                           else float("nan"))
        if scaler is not None:
            telemetry.note(loss_scale=scaler.loss_scale)
        if self._data_pipeline is not None:
            telemetry.note(samples_seen=int(
                self._data_pipeline.samples_seen))

    # -- optimizer states ------------------------------------------------------

    def save_states(self, fname):
        """Save the optimizer and its states (reference:
        Trainer.save_states); the states are pickled as host arrays.
        With ``update_on_kvstore`` they are the store's."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load ``save_states``'s file; the trainer keeps its own optimizer
        (and its step counts), as the JAX package's does."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            self._updaters[0].set_states(states)
            self._updaters[0].optimizer = self._optimizer
            self._validate_updater_states(fname)
        self._optimizer.param_dict = {
            i: param for i, param in enumerate(self._params)}

    def _validate_updater_states(self, fname):
        """Loaded states are keyed by parameter INDEX: if the parameter
        list changed (count or shapes) since the save, applying them would
        step the wrong tensors, so refuse."""

        def _leaves(state):
            if state is None:
                return []
            if isinstance(state, (list, tuple)):
                return [a for s in state for a in _leaves(s)]
            return [state] if isinstance(state, NDArray) else []

        states = self._updaters[0].states
        nparams = len(self._params)
        for idx, state in states.items():
            if not isinstance(idx, int) or idx < 0 or idx >= nparams:
                raise MXNetError(
                    f"Trainer.load_states: '{fname}' holds optimizer state "
                    f"for parameter index {idx!r}, but this trainer has "
                    f"only {nparams} parameters. The parameter list "
                    "changed since the states were saved.")
            param = self._params[idx]
            pshape = tuple(param.shape) if param.shape else None
            for arr in _leaves(state):
                if pshape is not None and tuple(arr.shape) != pshape:
                    raise MXNetError(
                        f"Trainer.load_states: state shape "
                        f"{tuple(arr.shape)} for parameter index {idx} "
                        f"('{param.name}') does not match the parameter "
                        f"shape {pshape}. The parameter list changed "
                        "since the states were saved.")


def kvstore_requires_store(kv):
    """A dist type always goes through its store (the cross-process
    reduce), even on one worker."""
    return kv.type.startswith("dist")


def _is_dtensor(param):
    import sys

    mod = sys.modules.get("torch.distributed.tensor")  # none made without
    return mod is not None and isinstance(param._tensor, mod.DTensor)
