"""Whole-step capture for the Gluon Trainer: ``Trainer.train_step`` as one
CUDA graph.

Counterpart of ``mxnet_tpu/gluon/captured.py``.  The JAX package traces
forward, loss, backward, gradient accumulation, health guard, clip and
optimizer update into one donated program; here the same step is recorded
once as a ``torch.cuda.CUDAGraph`` per capture signature and replayed:

    forward (training mode) -> loss -> torch.autograd.grad
    -> (sum over grad_accum microbatches, unrolled) -> health -> clip
    -> grouped update (optimizer.grouped.build_group_step, in place)

BatchNorm's running statistics move in place inside the graph, once a
microbatch, as they do eagerly.  One replay is one dispatch; the guard's
decision is the step's one host readback, after the replay.  Per-step
scalars live in device buffers that the host refills before each replay:
the dyn columns of every group (lr, wd, rescale_grad, the step-count
coefficients), the loss scale, and the seeds of the step's generators
(one a microbatch for a hybridized block, one for a hybridized loss,
drawn from the package chain in the order the eager forward draws them,
and registered with the graph so each replay draws as a fresh generator
of that seed does).  So LR schedules, loss-scale changes and optimizer
time steps replay the same graph.  The batch is copied into the graph's
static input buffers.  Before recording, the step runs once on a side
stream (cuDNN's autotuner and the allocator settle there) and every
tensor it wrote is restored.

Bitwise discipline: the eager path (``MXTPU_CAPTURED_STEP=0``) is the
oracle.  Both run the same forward, the same ``torch.autograd.grad``,
``numerics.health_of`` and ``build_group_step``, so captured equals eager
to the bit wherever the kernels are deterministic (on the card, under
``torch.use_deterministic_algorithms(True)``).  On the host there is no
graph: ``CapturedStep`` runs the same step function directly, with the
same cache, counters and eligibility, so the CPU tests hold captured
against eager.

The cache keeps ``MXTPU_CAPTURE_CACHE`` signatures a trainer (default 8),
first in first out; an eviction emits ``capture_cache_evict`` and
releases the evicted graph and its pool.  Besides the model, the
optimizer plan (``MXTPU_GROUP_MAX_ITEMS`` splits groups) and the batch,
the key holds the block's effective remat policy and the autotune
program knobs, so changing ``MXTPU_REMAT`` records again.

A capture failure raises ``MXNetError``, or the allocator's
``torch.cuda.OutOfMemoryError`` as it is, after releasing what the
failed recording held; it never falls back to the eager path.  What cannot be captured runs eagerly, per step, for the
reference's reasons (``ineligible_reason``): the fused step disabled, a
kvstore that reduces outside the step, ``update_on_kvstore``, an
optimizer without a grouped plan, a block that is not a hybridized
HybridBlock, a batch not divisible by ``grad_accum``, or parameters the
grouped rules cannot express.  A block hybridized with ``remat=`` runs
its forward as a rematerialised region inside the recording (its backward
recomputes it in the graph, with the dropout masks the forward drew); LoRA
attach, freeze and merge bump the blocks' cache versions, so the next
step records again.  The label may be a tuple of tensors (BERT's MLM and
NSP labels).  The reference's pipeline and mesh captures wait for those
features' slices.

Row-sparse tables (``embedding.ShardedEmbedding`` under SGD or Adam with
``lazy_update``) run inside the graph too.  The host prepares each
table's unique ids, inverse index and padding map every step
(``embedding.prep.prepare_step``, or the ``DevicePrefetcher``'s stash);
the padded unique-count bucket joins the capture key, so there is one
graph per bucket.  In the graph the touched rows are gathered first, the
forward reads them by inverse index, the gradient is taken with respect
to those rows (``(bucket, dim)``, never the table), and
``optimizer.grouped.step_group`` updates the rows of the table and its
states in place.  The ids enter through pinned staging, like the
scalars, so a step still has one readback.  Recording saves and restores
only the rows the warm-up run touches, never a copy of a table.  A
configuration that falls back to the eager oracle emits
``sparse_fallback{reason}`` (``Trainer.train_step``); a sparse step's
``lookup_us`` and ``unique_fraction`` go on its telemetry step record.

Telemetry and integrity: the step's FLOPs are counted once a capture,
over the warm-up run (``telemetry.count_flops``: the matmul counter plus
the flash kernels' own formula), and the device's allocation high-water
mark after it is the record's ``device_peak_bytes``.  The integrity flag
(``MXTPU_INTEGRITY``) joins the capture key, as the JAX package's does.
On an attestation step (``Trainer._integrity_due``) a pass of its own
after the replay fingerprints the parameters and optimizer states
(``integrity.trainer_leaves``) on the card, and its two words ride the
guard's one readback; every other step is the unchanged graph.  The
``bit_flip_param`` site flips a bit in the live state after a step.
"""

from __future__ import annotations

import os

import torch

from ..base import MXNetError


_UNSET = object()       # a step's FLOPs before its first run


def captured_step_enabled() -> bool:
    """MXTPU_CAPTURED_STEP gate (default on); 0/false/off routes
    ``Trainer.train_step`` to the eager oracle."""
    return os.environ.get("MXTPU_CAPTURED_STEP", "1").lower() \
        not in ("0", "false", "off", "")


# -- accounting ----------------------------------------------------------------
#
# dispatch: one per captured step.  trace: one per recording of the step
# (a capture on the card, the first run of a signature on the host), so a
# schedule tick must leave it unchanged.  hits/misses: the capture cache.

_DISPATCH_COUNT = 0
_TRACE_COUNT = 0
_CACHE_HITS = 0
_CACHE_MISSES = 0


def dispatch_count() -> int:
    return _DISPATCH_COUNT


def trace_count() -> int:
    return _TRACE_COUNT


def cache_stats() -> dict:
    return {"hits": _CACHE_HITS, "misses": _CACHE_MISSES}


def reset_counters() -> None:
    global _DISPATCH_COUNT, _TRACE_COUNT, _CACHE_HITS, _CACHE_MISSES
    _DISPATCH_COUNT = 0
    _TRACE_COUNT = 0
    _CACHE_HITS = 0
    _CACHE_MISSES = 0


# -- eligibility ---------------------------------------------------------------

def ineligible_reason(trainer, block, loss_fn, data, grad_accum):
    """Why this (trainer, block, loss) combination cannot be captured, or
    None when it can.  Cheap checks only: ``get_step`` plans the groups."""
    from .. import kvstore as _kvs
    from ..optimizer import grouped as _grouped
    from . import block as _blockmod

    if not _grouped.fused_step_enabled():
        return "fused step disabled (MXTPU_FUSED_STEP=0)"
    if not _kvs.captured_step_compatible(trainer._kvstore):
        return "kvstore reduction outside the step"
    if trainer._update_on_kvstore:
        return "update_on_kvstore"
    if not _grouped.has_plan(trainer._optimizer):
        return f"optimizer {type(trainer._optimizer).__name__} has no " \
               "grouped plan"
    if not isinstance(block, _blockmod.HybridBlock):
        return "block is not a HybridBlock"
    if not block._active:
        return "block is not hybridized"
    if not callable(loss_fn):
        return "loss is not callable"
    if isinstance(loss_fn, _blockmod.Block) \
            and not isinstance(loss_fn, _blockmod.HybridBlock):
        return "loss block is not a HybridBlock"
    k = int(grad_accum)
    if k < 1:
        return "grad_accum < 1"
    if data.shape[0] % k != 0:
        return f"batch {data.shape[0]} not divisible by grad_accum {k}"
    sparse = sparse_params(trainer)
    if sparse:
        from .. import embedding as _embedding

        return _embedding.sparse_capture_reason(trainer, block, sparse)
    return None


def sparse_params(trainer):
    """[(trainer index, Parameter)] of the trained row-sparse-gradient
    parameters."""
    return [(i, p) for i, p in enumerate(trainer._params)
            if p.grad_req != "null" and p.grad_stype == "row_sparse"]


def _tree_version(block):
    """DFS tuple of ``_cache_version`` over a block tree: any change a
    block records (a parameter or child registered, a tensor replaced by
    cast or deferred init, hybridize) anywhere in the tree changes it,
    and so misses the capture cache."""
    versions = [getattr(block, "_cache_version", 0)]
    for child in getattr(block, "_children", {}).values():
        versions.extend(_tree_version(child))
    return tuple(versions)


def _collect_blocks_params(block, loss_fn):
    """Ordered (name, param) pairs over the block's and the loss's
    parameters, deduplicated by identity."""
    from . import block as _blockmod

    pairs, seen = [], set()
    sources = [block.collect_params()]
    if isinstance(loss_fn, _blockmod.Block):
        sources.append(loss_fn.collect_params())
    for params in sources:
        for name, p in params.items():
            if id(p) not in seen:
                seen.add(id(p))
                pairs.append((name, p))
    return pairs


def _raw(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_raw(a) for a in x)
    return getattr(x, "_data", x)


def _sig(x):
    """Shapes, dtypes and devices of a tensor or a tuple of them."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_sig(a) for a in x)
    t = _raw(x)
    return (tuple(t.shape), str(t.dtype), str(t.device))


def _slice(x, lo, hi):
    if isinstance(x, (tuple, list)):
        return type(x)(_slice(a, lo, hi) for a in x)
    return x[lo:hi]


def _clone(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(a) for a in x)
    return x.detach().clone()


def _copy_into(dst, src):
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


# -- capture cache -------------------------------------------------------------

_MAX_CACHE = 8


def capture_cache_size():
    """How many capture signatures a trainer keeps, first in first out:
    ``MXTPU_CAPTURE_CACHE`` (at least 1), by default 8.  On the card each
    signature holds its graph and that graph's memory pool, so a process
    that cycles through many signatures (an autotune search) sets it to
    what fits."""
    from ..base import getenv_int

    return max(1, getenv_int("MXTPU_CAPTURE_CACHE", _MAX_CACHE))


def _program_knobs(block):
    """What changes the recorded step besides the model and the batch:
    the block's effective remat policy (its flag, else ``MXTPU_REMAT``)
    and the autotune program knobs.  Read on every step, so a changed
    value misses the cache and re-captures."""
    from .. import remat as _remat
    from ..autotune import space as _tune_space

    return (_remat.env_default(dict(block._flags).get("remat")),
            _tune_space.program_knob_values())


# optimizer attributes that enter the step as data (dyn columns) or count
# steps: a change in them must not re-capture
_DATA_ATTRS = frozenset(("lr", "wd", "rescale_grad", "num_update",
                         "begin_num_update", "m_schedule"))


def _hyper(optimizer):
    """The optimizer's scalar hyper-parameters a group plan may read."""
    return tuple(sorted(
        (k, v) for k, v in vars(optimizer).items()
        if isinstance(v, (bool, int, float, str, type(None)))
        and k not in _DATA_ATTRS))


def _fast_key(trainer, block, loss_fn, data, label, k, sparse_key=(),
              knobs=()):
    """What decides a capture, read cheaply each step: the block's and the
    loss's cache versions, the grad_req layout, the optimizer's type and
    scalar hyper-parameters and its state dict, the guard, clip and amp
    flags, the batch's shapes, dtypes and device, ``grad_accum`` and the
    program knobs.  A miss falls through to ``get_step``'s full
    planning."""
    from .. import numerics

    upd = trainer._updaters[0]
    return (
        id(block), _tree_version(block),
        id(loss_fn), _tree_version(loss_fn),
        bool(getattr(loss_fn, "_active", False)),
        tuple(p.grad_req for p in trainer._params),
        type(trainer._optimizer), _hyper(trainer._optimizer),
        id(upd.states), len(upd.states),
        numerics.grad_guard_enabled(), trainer._clip_norm(),
        getattr(trainer, "_amp_loss_scaler", None) is not None, int(k),
        _sig(data), _sig(label), sparse_key, knobs,
    )


def get_step(trainer, block, loss_fn, data, label, grad_accum):
    """The (possibly cached) ``CapturedStep`` for this call, or None when
    the step must run eagerly.

    The key: the block's and the loss's cache versions, the grad_req
    layout, the group plans (rule, static hyper-params, dtype, indices),
    the guard, clip and amp flags, the batch's shapes, dtypes and device,
    ``grad_accum``, the visible devices, the effective remat policy and
    the autotune program knobs.  Per-step scalars are not in it: they are
    data.  A step whose ``_fast_key`` was seen before skips the planning.
    The cache keeps ``capture_cache_size()`` signatures; an eviction
    emits ``capture_cache_evict`` and releases the evicted step's graph
    and pool."""
    global _CACHE_HITS, _CACHE_MISSES
    from .. import integrity as _integrity
    from .. import kvstore as _kvs
    from .. import numerics
    from ..optimizer import grouped as _grouped

    trainer._sparse_fallback_reason = None
    trainer._sparse_prep = None
    if ineligible_reason(trainer, block, loss_fn, data, grad_accum) \
            is not None:
        return None
    k = int(grad_accum)
    # the sparse tables' host prep runs every call, before the key: the
    # padded unique-count bucket is part of the capture signature
    sparse = sparse_params(trainer)
    sparse_key = ()
    if sparse:
        from .. import embedding as _embedding
        from .. import telemetry as _telemetry

        preps, why, lookup_us = _embedding.prepare_step(block, data, sparse)
        if preps is None:
            trainer._sparse_fallback_reason = why
            return None
        sparse_key = tuple((i, pr.bucket) for (i, _p), pr in zip(sparse,
                                                                  preps))
        _telemetry.note(
            lookup_us=float(lookup_us),
            unique_fraction=sum(pr.n_real for pr in preps)
            / max(sum(pr.n_ids for pr in preps), 1))
        trainer._sparse_prep = preps
    fast = getattr(trainer, "_captured_fast", None)
    if fast is None:
        fast = trainer._captured_fast = {}
    knobs = _program_knobs(block)
    fkey = _fast_key(trainer, block, loss_fn, data, label, k, sparse_key,
                     knobs)
    step = fast.get(fkey)
    if step is not None:
        _CACHE_HITS += 1
        return step
    block._ensure_initialized(data)
    trained = [(i, p) for i, p in enumerate(trainer._params)
               if p.grad_req != "null"]
    if not trained:
        return None
    block_ids = {id(p) for _n, p in _collect_blocks_params(block, loss_fn)}
    if any(id(p) not in block_ids for _i, p in trained):
        return None     # the trainer updates parameters the step never sees
    indices = [i for i, _p in trained]
    weights = [p.data() for _i, p in trained]
    # the weights stand in for the dense gradients (a gradient takes its
    # parameter's dtype, which decides the grouping); a row-sparse
    # parameter's own gradient buffer picks the row-sparse rule
    standins = [p.grad() if p.grad_stype == "row_sparse" else w
                for (_i, p), w in zip(trained, weights)]
    groups, fallback = _grouped.plan_items(trainer._updaters[0], indices,
                                           standins, weights)
    if fallback:
        return None
    guard_on = numerics.grad_guard_enabled()
    clip = trainer._clip_norm()
    has_scaler = getattr(trainer, "_amp_loss_scaler", None) is not None
    plan_sig = tuple(gkey + (tuple(it[0] for it in items),)
                     for gkey, items in groups.items())
    key = (
        id(block), _tree_version(block),
        id(loss_fn), _tree_version(loss_fn),
        bool(getattr(loss_fn, "_active", False)),
        tuple((i, p.grad_req) for i, p in enumerate(trainer._params)),
        plan_sig, guard_on, clip, has_scaler, k,
        _sig(data), _sig(label), _kvs.device_fingerprint(), sparse_key,
        knobs, _integrity.fingerprint_enabled(),
    )
    cache = getattr(trainer, "_captured_cache", None)
    if cache is None:
        cache = trainer._captured_cache = {}
    step = cache.get(key)
    if step is not None:
        _CACHE_HITS += 1
        step._groups = groups     # fresh state references, the same plan
        step._recheck = True
    else:
        _CACHE_MISSES += 1
        step = CapturedStep(trainer, block, loss_fn, trained, groups,
                            guard_on=guard_on, clip=clip,
                            has_scaler=has_scaler, grad_accum=k,
                            sparse=[i for i, _p in sparse])
        cap = capture_cache_size()
        while len(cache) >= cap:
            evicted = cache.pop(next(iter(cache)))
            for fk in [fk for fk, s in fast.items() if s is evicted]:
                del fast[fk]
            evicted.release()
            # the next step of that signature records again: worth a line
            from .. import telemetry as _telemetry

            _telemetry.event("capture_cache_evict", cache_size=cap,
                             kept=len(cache))
        cache[key] = step
    fast[fkey] = step
    return step


class CapturedStep:
    """One recorded train step and the host bookkeeping around it: the
    update-count bump, the dyn columns, the seeds and the batch go into
    the step's buffers, one replay runs it, and the guarded finalize does
    the one readback."""

    def __init__(self, trainer, block, loss_fn, trained, groups, guard_on,
                 clip, has_scaler, grad_accum, sparse=()):
        from . import block as _blockmod

        self._block = block
        self._loss_fn = loss_fn
        self._trained = trained              # [(trainer index, Parameter)]
        self._groups = groups
        self._guard_on = bool(guard_on)
        self._clip = clip
        self._want_guard = bool(guard_on) or clip is not None
        self._has_scaler = bool(has_scaler)
        self._k = int(grad_accum)
        self._loss_keyed = isinstance(loss_fn, _blockmod.HybridBlock) \
            and bool(loss_fn._active)
        trained_ids = {id(p) for _i, p in trained}
        self._others = [p for _n, p in _collect_blocks_params(block, loss_fn)
                        if id(p) not in trained_ids]
        self._pos = {i: j for j, (i, _p) in enumerate(trained)}
        # row-sparse tables: (position among the trained, table param id)
        self._sparse = [(self._pos[i], id(trainer._params[i]))
                        for i in sparse]
        self._graph = None
        self._graph_ptrs = None
        self._uniform = None
        self._recheck = True
        self._fresh = True
        self._flops = _UNSET
        self._peak_bytes = None
        from .. import integrity as _integrity

        self._want_fp = _integrity.fingerprint_enabled()

    # -- the step ---------------------------------------------------------------

    def _run(self, x, y, scale, gens_b, gens_l, dyn_list, sp=()):
        """forward, loss, gradients (summed over the microbatches), health,
        grouped update in place; returns (losses, health).  ``sp`` holds
        each row-sparse table's (uniq, src, inv) index tensors, ``inv``
        (k, ids per microbatch)."""
        from contextlib import nullcontext

        from .. import autograd as _ag
        from .. import numerics
        from .. import random as _random
        from ..embedding import prep as _embprep
        from ..optimizer import grouped as _grouped

        params = [p._value() for _i, p in self._trained]
        # a row-sparse table enters as its gathered unique rows: the
        # gradient, and its sum over microbatches, is (bucket, dim)
        leaves = list(params)
        for (pos, _pid), (uniq, _src, _inv) in zip(self._sparse, sp):
            leaves[pos] = params[pos].detach().index_select(0, uniq) \
                .requires_grad_()
        k = self._k
        m = x.shape[0] // k
        losses, grads = [], None
        with _ag.train_mode(), torch.enable_grad():
            for j in range(k):
                xs = x if k == 1 else x[j * m:(j + 1) * m]
                ys = y if (k == 1 or y is None) \
                    else _slice(y, j * m, (j + 1) * m)
                scope = _embprep.capture_scope(
                    {pid: (leaves[pos], inv[j]) for (pos, pid), (_u, _s, inv)
                     in zip(self._sparse, sp)}) if self._sparse \
                    else nullcontext()
                with scope, _random.generator_scope(gens_b[j]):
                    out = self._block(xs)
                if self._loss_keyed:
                    with _random.generator_scope(gens_l[j]):
                        loss = self._loss_fn(out, ys) if ys is not None \
                            else self._loss_fn(out)
                else:
                    loss = self._loss_fn(out, ys) if ys is not None \
                        else self._loss_fn(out)
                head = loss * scale if self._has_scaler else loss
                gs = torch.autograd.grad(head, leaves,
                                         torch.ones_like(head))
                losses.append(loss.detach())
                grads = list(gs) if k == 1 else [
                    a + g for a, g in zip(grads or [torch.zeros_like(p)
                                                    for p in leaves], gs)]
        losses = losses[0] if k == 1 else torch.stack(losses)
        rows_of = {pos: (uniq, src) for (pos, _pid), (uniq, src, _inv)
                   in zip(self._sparse, sp)}
        with torch.no_grad():
            health = numerics.health_of(grads) if self._want_guard else None
            for (gkey, items), dyn in zip(self._groups.items(), dyn_list):
                pos = [self._pos[it[0]] for it in items]
                rows = [rows_of[p] for p in pos] \
                    if _grouped.is_sparse_kernel(gkey[0]) else None
                _grouped.step_group(gkey, items, dyn,
                                    grads=[grads[p] for p in pos],
                                    health=health, guarded=self._guard_on,
                                    clip=self._clip, rows=rows)
        return losses, health

    def _mutable(self):
        """Every tensor a step writes, as (dense, tables): the trained
        parameters, their f32 masters and optimizer states, and the other
        parameters (running statistics); then the row-sparse tables and
        their states, of which a step writes only the gathered rows."""
        from ..optimizer import grouped as _grouped

        out, rows = [], []
        for gkey, items in self._groups.items():
            dst = rows if _grouped.is_sparse_kernel(gkey[0]) else out
            for _i, w, _g, st, _d, m in items:
                dst.append(w._data)
                dst.extend(s._data for s in st)
                if m is not None:
                    dst.append(m._data)
        grouped = {id(t) for t in out + rows}
        out.extend(p._value() for _i, p in self._trained
                   if id(p._value()) not in grouped)
        out.extend(p._value() for p in self._others)
        return out, rows

    # -- per-step host driver ---------------------------------------------------

    def __call__(self, trainer, data, label, batch_size):
        global _DISPATCH_COUNT, _TRACE_COUNT
        from .. import integrity as _integrity
        from .. import numerics
        from .. import profiler
        from .. import random as _random
        from .. import resilience as _resilience
        from ..ndarray.ndarray import NDArray
        from ..optimizer import grouped as _grouped

        o = trainer._optimizer
        trainer._set_rescale(batch_size)
        indices = [i for i, _p in self._trained]
        snapshot = trainer._snapshot_update_counts(indices) \
            if self._guard_on else None
        for i in indices:
            o._update_count(i)
        rows = [_grouped.dyn_rows(o, items) for items in self._groups.values()]
        seeds_b, seeds_l = [], []
        for _ in range(self._k):
            seeds_b.append(_random.next_seed())
            if self._loss_keyed:
                seeds_l.append(_random.next_seed())
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        scale = float(scaler.loss_scale) if scaler is not None else 1.0
        x = _raw(data)
        y = None if label is None else _raw(label)
        # the host-prepared sparse indices (get_step ran the prep): the
        # inverse index as (k, ids per microbatch), batch-major as the
        # microbatch slices of x
        sp = []
        if self._sparse:
            preps, trainer._sparse_prep = trainer._sparse_prep, None
            sp = [(pr.uniq, pr.src, pr.inv.reshape(self._k, -1))
                  for pr in preps]
        attest = self._want_fp and trainer._integrity_due()
        with profiler.annotate("captured_step"):
            if x.device.type == "cuda":
                losses, health = self._replay(x, y, scale, seeds_b,
                                              seeds_l, rows, sp)
            else:
                dev = x.device
                gens_b = [_random.generator(s, dev) for s in seeds_b]
                gens_l = [_random.generator(s, dev) for s in seeds_l]
                dyn_list = [_grouped.as_columns(
                    row, _grouped.compute_dtype(gkey), dev)
                    for gkey, row in zip(self._groups, rows)]
                args = (x, y, torch.tensor(scale, dtype=torch.float32,
                                           device=dev),
                        gens_b, gens_l, dyn_list,
                        [tuple(torch.from_numpy(a) for a in t) for t in sp])
                if self._fresh:
                    _TRACE_COUNT += 1
                    self._fresh = False
                losses, health = self._counted(lambda: self._run(*args))
            # the attestation pass, after the step on the same stream:
            # nothing is read back until the guard's readback
            fp = _integrity.fingerprint_arrays(
                _integrity.trainer_leaves(trainer)) if attest else None
        _DISPATCH_COUNT += 1
        if _resilience.fault_armed("bit_flip_param"):
            # memory corruption of the live state after the step: this
            # step's fingerprint is clean, the next attestation is not
            _integrity.maybe_bit_flip_param(
                params=[p for _i, p in self._trained])
        trainer._step_count += 1
        if self._want_guard:
            guard = numerics.StepGuard(health, skip=self._guard_on,
                                       clip=self._clip, extra=fp)
            trainer._finalize_guarded_step(guard, snapshot)
        elif fp is not None:
            # no guard: the attestation readback is the step's one sync
            trainer._integrity_attest(_integrity.combine(fp))
        ctx = getattr(data, "_ctx", None)
        return NDArray(losses, ctx)

    # -- program accounting (telemetry.py) --------------------------------------

    def _counted(self, run):
        """``run()``, its FLOPs counted the first time with telemetry on
        (``telemetry.count_flops``)."""
        from .. import telemetry

        if self._flops is not _UNSET or not telemetry.enabled():
            return run()
        out, self._flops = telemetry.count_flops(run)
        return out

    def cost_flops(self):
        """The step's FLOPs, counted once a capture over its first run,
        or None before that or with telemetry off."""
        return None if self._flops is _UNSET else self._flops

    def memory_high_water(self):
        """The card's allocation high-water mark in bytes after the
        step's warm-up run (``torch.cuda.max_memory_allocated``), which
        holds the step's own peak; None on the host."""
        return self._peak_bytes

    def release(self):
        """Drop the recorded graph, its memory pool and the static buffers
        (an evicted signature, a failed recording); a later call records
        again.  The allocator's cache is emptied, so the card gets the
        memory back."""
        graph, self._graph = self._graph, None
        self._static = self._packs = self._graph_ptrs = None
        self._uploaded = None
        if graph is not None:
            graph.reset()
            del graph
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    # -- the CUDA graph ---------------------------------------------------------

    def _pointers(self):
        """The addresses of every tensor the recorded graph reads or
        writes: replaced tensors (loaded optimizer states) need a new
        recording."""
        dense, tables = self._mutable()
        return tuple(t.data_ptr() for t in dense + tables)

    def _replay(self, x, y, scale, seeds_b, seeds_l, rows, sp):
        global _TRACE_COUNT
        uni = tuple(tuple(_is_uni(v) for v in row.values()) for row in rows)
        if self._graph is None or uni != self._uniform or (
                self._recheck and self._pointers() != self._graph_ptrs):
            self._capture(x, y, rows, sp)
            self._uniform, self._graph_ptrs = uni, self._pointers()
            _TRACE_COUNT += 1
        self._recheck = False
        st = self._static
        st["x"].copy_(x)
        if y is not None:
            _copy_into(st["y"], y)
        self._upload(scale, rows, sp)
        for gen, s in zip(st["gens_b"] + st["gens_l"], seeds_b + seeds_l):
            gen.manual_seed(s)
        self._graph.replay()
        return st["losses"].clone(), st["health"]

    def _upload(self, scale, rows, sp=()):
        """The step's scalars and sparse indices to the graph's buffers:
        one pinned staging tensor and one asynchronous copy for each dtype
        (the f32 one leads with the loss scale) and for each index array.
        The staging tensors are rewritten only after the previous step's
        copies have finished."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
        for dt, pack in self._packs.items():
            vals = [scale] if dt == torch.float32 else []
            for gi, name in pack["slots"]:
                vals.extend(rows[gi][name])
            pack["host"].copy_(torch.tensor(vals, dtype=dt))
            pack["dev"].copy_(pack["host"], non_blocking=True)
        for arrays, bufs in zip(sp, self._static["sp"]):
            for a, (host, dev) in zip(arrays, bufs):
                host.numpy()[...] = a
                dev.copy_(host, non_blocking=True)
        self._uploaded = torch.cuda.Event()
        self._uploaded.record()

    def _capture(self, x, y, rows, sp=()):
        """Record the step: static buffers, one warm-up run on a side
        stream with every written tensor (of a row-sparse table, every
        written row) restored after it, then the graph.  A failure leaves
        no stream capturing and no pool held (``release``) and raises
        ``MXNetError``; running out of memory raises the allocator's
        ``torch.cuda.OutOfMemoryError`` itself, which an autotune trial
        reads as an infeasible candidate."""
        dev = x.device
        self._graph = None
        prev_stream = torch.cuda.current_stream(dev)
        try:
            self._record(x, y, rows, sp, dev)
        except BaseException as e:
            if torch.cuda.is_current_stream_capturing():
                # the capture cannot be ended cleanly here: the process
                # cannot use the card any more
                raise
            torch.cuda.set_stream(prev_stream)
            self.release()
            if isinstance(e, (MXNetError, torch.cuda.OutOfMemoryError)) \
                    or not isinstance(e, Exception):
                raise
            raise MXNetError(f"capturing the train step as a CUDA graph "
                             f"failed: {type(e).__name__}: {e}") from e

    def _record(self, x, y, rows, sp, dev):
        from ..optimizer import grouped as _grouped

        st = {"x": x.detach().clone(),
              "y": None if y is None else _clone(y),
              "sp": [[(torch.empty(a.shape, dtype=torch.int64,
                                   pin_memory=True),
                       torch.empty(a.shape, dtype=torch.int64, device=dev))
                      for a in arrays] for arrays in sp]}
        self._static = st
        st["gens_b"] = [torch.Generator(device=dev) for _ in range(self._k)]
        st["gens_l"] = [torch.Generator(device=dev)
                        for _ in range(self._k if self._loss_keyed else 0)]
        # the scalars' buffers: views into one device tensor a dtype
        layout = {torch.float32: 1}
        slots = {}
        for gi, (gkey, row) in enumerate(zip(self._groups, rows)):
            dt = _grouped.compute_dtype(gkey)
            for name, vals in row.items():
                off = layout.get(dt, 0)
                slots.setdefault(dt, []).append((gi, name, off, len(vals)))
                layout[dt] = off + len(vals)
        self._packs = {dt: {"dev": torch.zeros(n, dtype=dt, device=dev),
                            "host": torch.zeros(n, dtype=dt,
                                                pin_memory=True),
                            "slots": [(gi, name) for gi, name, _o, _n
                                      in slots.get(dt, [])]}
                       for dt, n in layout.items()}
        self._uploaded = None
        dyn_list = [{} for _ in rows]
        for dt, entries in slots.items():
            buf = self._packs[dt]["dev"]
            for gi, name, off, n in entries:
                dyn_list[gi][name] = _grouped.Col(
                    buf[off:off + n], _is_uni(rows[gi][name]))
        st["scale"] = self._packs[torch.float32]["dev"][0]
        self._upload(1.0, rows, sp)
        sp_dev = [tuple(d for _h, d in bufs) for bufs in st["sp"]]
        args = (st["x"], st["y"], st["scale"], st["gens_b"], st["gens_l"],
                dyn_list, sp_dev)
        dense, tables = self._mutable()
        uniq = self._sparse_uniq(sp_dev)
        saved = [t.detach().clone() for t in dense]
        saved_rows = [t.index_select(0, u) for t, u in zip(tables, uniq)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._counted(lambda: self._run(*args))
        torch.cuda.current_stream(dev).wait_stream(side)
        self._peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        with torch.no_grad():
            torch._foreach_copy_(dense, saved)
            for t, u, r in zip(tables, uniq, saved_rows):
                t.index_copy_(0, u, r)
        del saved, saved_rows
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise MXNetError(
                "this torch has no CUDAGraph.register_generator_state: "
                "the step's generators cannot replay")
        for gen in st["gens_b"] + st["gens_l"]:
            register(gen)
        # held by the step until the recording ends, so a failure inside
        # it releases this graph's pool too
        self._graph = graph
        with torch.cuda.graph(graph):
            st["losses"], st["health"] = self._run(*args)
        if st["health"] is None:
            st["health"] = torch.ones(2, device=dev)
        self._graph = graph

    def _sparse_uniq(self, sp):
        """The unique-id tensor of the table each of ``_mutable``'s
        row-sparse tensors belongs to, in that order."""
        from ..optimizer import grouped as _grouped

        uniq_of = {pos: arrays[0] for (pos, _pid), arrays
                   in zip(self._sparse, sp)}
        out = []
        for gkey, items in self._groups.items():
            if not _grouped.is_sparse_kernel(gkey[0]):
                continue
            for i, _w, _g, st, _d, m in items:
                u = uniq_of[self._pos[i]]
                out.extend([u] * (1 + len(st) + (m is not None)))
        return out


def _is_uni(vals):
    from ..optimizer import grouped as _grouped

    return _grouped.is_uniform(vals)
