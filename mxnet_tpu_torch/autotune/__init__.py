"""The self-tuning layer: measure, search, persist, replay.

Counterpart of ``mxnet_tpu/autotune/__init__.py``:

- ``space``: the knobs, their domains and layers, and the numerics-safety
  flag (semantics-changing knobs only behind ``MXTPU_TUNE_SEMANTICS=1``);
- ``runner``: scores one candidate on the live trainer through its own
  step path; an out-of-memory candidate is infeasible;
- ``search``: successive halving, ``MXTPU_TUNE_BUDGET`` trials a capture
  signature;
- ``db``: the CRC'd JSONL database, keyed by (capture signature, device
  kind, mesh shape).

``Trainer.train_step`` calls :func:`maybe_tune` once per capture
signature: ``MXTPU_AUTOTUNE=replay`` (the default) applies a stored
winner with zero trials, ``search`` searches when the database has no
entry and stores the winner, ``off`` does nothing.
``ShardedTrainer.step`` replays only (:func:`replay_for_sharded`).

The device kind is the card's name (``torch.cuda.get_device_name``), or
``"cpu"`` without a card.
"""

from __future__ import annotations

import hashlib
import json
import os

from .. import telemetry
from . import db, runner, search, space  # noqa: F401  (public submodules)

#: guards re-entry: trial steps call Trainer.train_step, which calls
#: maybe_tune again.
_IN_PROGRESS = False


def device_kind():
    """The card's name, or "cpu" when there is none."""
    import torch

    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:       # noqa: BLE001 — CUDA did not answer
        return "unknown"
    return "cpu"


def _mesh_shape(mesh):
    """A mesh's ((axis, size), ...) or None (one device, no mesh)."""
    if mesh is None:
        return None
    return tuple(sorted(mesh.shape.items()))


def _norm_name(name):
    """Strip the per-process block-name counters ('dense3_weight' ->
    'dense_weight'): a restarted process must hash to the same
    signature for the same model."""
    import re

    return re.sub(r"\d+", "", str(name))


def _dtype_name(x):
    """A dtype's short name, the same for a tensor and an array
    ('float32', 'bfloat16')."""
    return str(getattr(x, "dtype", "")).replace("torch.", "")


def signature_of(trainer, block, loss_fn, data, grad_accum):
    """The capture signature without object ids (a database entry must
    survive restarts): the model's class, its parameters (names without
    counters, shapes, dtypes, grad_req), the loss's and the optimizer's
    classes, the batch and ``grad_accum``."""
    params = []
    for p in trainer._params:
        params.append((_norm_name(getattr(p, "name", "")),
                       tuple(getattr(p, "shape", ()) or ()),
                       _dtype_name(p),
                       getattr(p, "grad_req", "write")))
    blob = json.dumps({
        "block": type(block).__name__,
        "loss": type(loss_fn).__name__,
        "optimizer": type(trainer._optimizer).__name__,
        "params": params,
        "batch": [tuple(data.shape), _dtype_name(data)],
        "grad_accum": int(grad_accum),
    }, sort_keys=True, default=str, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def effective_grad_accum(k, data):
    """The semantics-changing grad-accum override: honoured only behind
    MXTPU_TUNE_SEMANTICS, and only when it divides the batch."""
    if not space.semantics_opt_in():
        return k
    raw = os.environ.get("MXTPU_GRAD_ACCUM")
    if not raw:
        return k
    try:
        ka = int(raw)
    except ValueError:
        return k
    if ka >= 1 and data.shape[0] % ka == 0:
        return ka
    return k


def _apply_entry(key, entry):
    space.apply_config(entry["config"])
    telemetry.event("tune_db_hit", key=key,
                    fingerprint=entry.get("fingerprint"),
                    score_us=entry.get("score_us"))


def maybe_tune(trainer, block, loss_fn, data, label, grad_accum):
    """``Trainer.train_step``'s consult.  Once per (signature, device
    kind, mesh) on this trainer it replays a stored winner or, under
    ``MXTPU_AUTOTUNE=search`` with no entry, searches on the live trainer;
    returns the effective grad-accum factor."""
    global _IN_PROGRESS
    mode = search.mode()
    if mode == "off" or _IN_PROGRESS:
        # trial steps still honour the candidate's grad-accum env
        return effective_grad_accum(int(grad_accum), data)
    # the full signature hashes every parameter: compute it only the first
    # time this cheap call shape appears
    cheap = (id(block), id(loss_fn), tuple(data.shape),
             str(data.dtype), int(grad_accum), mode)
    seen = getattr(trainer, "_autotune_seen", None)
    if seen is None:
        seen = trainer._autotune_seen = set()
    if cheap not in seen:
        seen.add(cheap)
        key = db.entry_key(
            signature_of(trainer, block, loss_fn, data, grad_accum),
            device_kind(), None)
        entry = db.lookup(key)
        if entry is not None:
            _apply_entry(key, entry)
        elif mode == "search":
            _search_and_apply(trainer, block, loss_fn, data, label,
                              int(grad_accum), key)
    return effective_grad_accum(int(grad_accum), data)


def _search_and_apply(trainer, block, loss_fn, data, label,
                      grad_accum, key):
    """Search on the live trainer (trial steps do train: tuning is part
    of the warm-up), then apply and store the winner."""
    global _IN_PROGRESS
    base = space.current_config()
    base_fp = space.fingerprint(base)

    def step_fn():
        trainer.train_step(block, loss_fn, data, label=label,
                           grad_accum=grad_accum)

    _IN_PROGRESS = True
    try:
        winner, results = search.successive_halving(step_fn, base=base)
    finally:
        _IN_PROGRESS = False
    trainer._autotune_results = results
    if not winner.feasible:
        # every candidate ran out of memory: keep the defaults, store
        # nothing
        return
    base_scores = [r.score_us for r in results
                   if r.fingerprint == base_fp and r.feasible]
    default_score = min(base_scores) if base_scores else None
    space.apply_config(winner.config)
    db.record(key, winner.config, winner.score_us, mfu=winner.mfu,
              trials=len(results), default_score_us=default_score)
    improvement = (default_score / winner.score_us) \
        if default_score else None
    telemetry.event(
        "tune_winner", key=key, fingerprint=winner.fingerprint,
        score_us=round(winner.score_us, 1),
        default_score_us=None if default_score is None
        else round(default_score, 1),
        improvement=None if improvement is None
        else round(improvement, 4),
        trials=len(results))


def sharded_signature(sharded_trainer, example):
    """``signature_of`` for a ``parallel.ShardedTrainer`` (its trainable
    list, its pure optimizer, its grad_accum)."""
    from ..parallel.trainer import _leaves

    st = sharded_trainer
    params = [(_norm_name(n), tuple(getattr(p, "shape", ()) or ()),
               _dtype_name(p))
              for n, p in getattr(st, "_trainable", [])]
    shapes = [(tuple(x.shape), _dtype_name(x)) for x in _leaves(example)]
    blob = json.dumps({
        "block": type(st.block).__name__,
        "loss": type(st.loss_fn).__name__,
        "optimizer": st.optimizer.name,
        "params": params,
        "batch": shapes,
        "grad_accum": int(st._grad_accum),
    }, sort_keys=True, default=str, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def replay_for_sharded(signature, mesh):
    """``ShardedTrainer``'s consult before its first step: replay only.
    Returns the applied entry or None."""
    if search.mode() == "off":
        return None
    key = db.entry_key(signature, device_kind(), _mesh_shape(mesh))
    entry = db.lookup(key)
    if entry is not None:
        _apply_entry(key, entry)
    return entry
