"""The autotuner's knob space: each tunable with its environment
variable, its domain, the layer it acts on and whether it keeps the
numbers as they are.

Counterpart of ``mxnet_tpu/autotune/space.py``, with the same knobs in
the same order and the same domains and defaults, so a configuration and
its fingerprint mean the same in both packages.  Numerics-preserving
knobs change how the same arithmetic runs (prefetch depth, shared-memory
slots, remat, the optimizer's group size) and are searched by default;
the grad-accum factor changes the update for the same global batch and
is searched only under ``MXTPU_TUNE_SEMANTICS=1``, and never replayed
without it.

Applying a configuration sets environment variables, which the consumers
read when they run (``optimizer.grouped.group_max_items``,
``remat.env_default``, the prefetcher, the worker loader,
``embedding.prep``).  Knobs of the ``program`` layer change the recorded
step, so ``gluon/captured.py`` keys its capture cache on their values: a
changed value re-captures.

Where the port differs: ``pp_microbatches`` is declared but has no
consumer yet (pipelines come with the pipeline slice), so the search
leaves it alone (``Knob.live``).  ``allreduce_bucket_mb`` (the store's
buckets and the sharded trainer's gradient buckets) and ``fsdp_min_size``
(``parallel.sharding.FSDPRules``) are live.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..base import MXNetError


class Knob:
    """One registered tunable: an env-backed value with a finite search
    domain."""

    __slots__ = ("name", "env", "domain", "default", "layer",
                 "numerics_preserving", "doc", "live")

    def __init__(self, name, env, domain, default, layer,
                 numerics_preserving=True, doc="", live=True):
        assert default in domain, (name, default, domain)
        self.live = bool(live)
        self.name = name
        self.env = env
        self.domain = tuple(str(v) for v in domain)
        self.default = str(default)
        self.layer = layer
        self.numerics_preserving = bool(numerics_preserving)
        self.doc = doc

    def current(self):
        """The active value: env var if set (and in-domain values only
        normalize trivially — out-of-domain env values pass through so
        hand-set configs are honored), else the default."""
        raw = os.environ.get(self.env)
        return raw if raw not in (None, "") else self.default

    def validate(self, value):
        if str(value) not in self.domain:
            raise MXNetError(
                f"knob {self.name}: value {value!r} not in domain "
                f"{self.domain}")
        return str(value)

    def neighbors(self, value):
        """Domain values adjacent to ``value`` (local-search moves).
        Out-of-domain current values get the whole domain as
        neighborhood."""
        value = str(value)
        if value not in self.domain:
            return list(self.domain)
        i = self.domain.index(value)
        out = []
        if i > 0:
            out.append(self.domain[i - 1])
        if i + 1 < len(self.domain):
            out.append(self.domain[i + 1])
        return out


#: name -> Knob, declaration order = reporting order.
KNOBS = {}


def register(knob):
    KNOBS[knob.name] = knob
    return knob


register(Knob(
    "allreduce_bucket_mb", "MXTPU_ALLREDUCE_BUCKET_MB",
    ("1", "2", "4", "8", "16"), "4", layer="collective",
    doc="gradient all-reduce bucket budget (kvstore.bucketed_pushpull, "
        "parallel.ShardedTrainer's dp reduce)"))
register(Knob(
    "fsdp_min_size", "MXTPU_FSDP_MIN_SIZE",
    ("256", "1024", "4096", "16384"), "1024", layer="sharding",
    doc="smallest param FSDPRules will shard (parallel/sharding.py)"))
register(Knob(
    "device_prefetch", "MXTPU_DEVICE_PREFETCH",
    ("0", "1", "2", "4"), "2", layer="input",
    doc="device-prefetch queue depth (gluon/data/prefetcher.py)"))
register(Knob(
    "shm_slot_mb", "MXTPU_SHM_SLOT_MB",
    ("8", "16", "32", "64"), "32", layer="input",
    doc="shared-memory slot size of the worker dataloader"))
register(Knob(
    "remat", "MXTPU_REMAT",
    ("none", "dots", "full", "save_every_k:2"), "none",
    layer="program",
    doc="rematerialization policy (remat.py registry; bitwise-safe)"))
register(Knob(
    "group_max_items", "MXTPU_GROUP_MAX_ITEMS",
    ("0", "8", "32"), "0", layer="program",
    doc="max params fused per optimizer group, 0 = unlimited "
        "(optimizer/grouped.plan_items)"))
register(Knob(
    "pp_microbatches", "MXTPU_PP_MICROBATCHES",
    ("0", "1", "2", "4", "8"), "0", layer="program",
    numerics_preserving=False, live=False,
    doc="microbatches per pipeline stage-pass in the captured 1F1B "
        "schedule, 0 = auto (the mesh's pp size); program-affecting — "
        "folded into the capture-cache key (gluon/captured.py).  Like "
        "grad_accum it CHANGES update math for the same global batch "
        "(captured(k, m) matches the eager oracle at grad_accum=k*m), "
        "so the search touches it only with MXTPU_TUNE_SEMANTICS=1"))
register(Knob(
    "unique_bucket", "MXTPU_UNIQUE_BUCKET",
    ("0", "256", "1024", "4096"), "0", layer="program",
    doc="fixed unique-id bucket for captured sparse-embedding steps, "
        "0 = auto (next power of two per batch); program-affecting — "
        "the bucket is the padded gather width and joins the capture "
        "key (embedding/prep.py, gluon/captured.py).  A fixed bucket "
        "trades one capture signature for padding waste; a batch whose "
        "unique count exceeds it falls back to the eager oracle with a "
        "sparse_fallback telemetry event.  Bitwise-neutral: padded "
        "rows never reach the table"))
register(Knob(
    "grad_accum", "MXTPU_GRAD_ACCUM",
    ("1", "2", "4"), "1", layer="schedule",
    numerics_preserving=False,
    doc="grad-accum factor override — CHANGES update math for the same "
        "global batch; searched only with MXTPU_TUNE_SEMANTICS=1"))


def semantics_opt_in():
    """MXTPU_TUNE_SEMANTICS gate (default off): allow the search to
    touch semantics-changing knobs."""
    return os.environ.get("MXTPU_TUNE_SEMANTICS", "0").lower() \
        not in ("0", "false", "off", "")


def searchable_knobs(include_semantics_changing=None):
    """The knobs the search may move, in declaration order: the
    live ones (a consumer in the port reads them), semantics-changing
    ones only with the opt-in."""
    if include_semantics_changing is None:
        include_semantics_changing = semantics_opt_in()
    return [k for k in KNOBS.values() if k.live
            and (k.numerics_preserving or include_semantics_changing)]


def default_config():
    return {k.name: k.default for k in KNOBS.values()}


def current_config():
    """The active config as {knob name: value string} (env or default
    per knob)."""
    return {k.name: k.current() for k in KNOBS.values()}


def apply_config(config):
    """Set each knob's env var from ``config`` (missing knobs reset to
    default) and stamp the fingerprint into telemetry.  Returns the
    previous env values for `restore_env`.  The consuming modules
    re-read env at use time, so this IS the runtime re-application."""
    from .. import telemetry

    prev = {}
    opt_in = semantics_opt_in()
    for knob in KNOBS.values():
        if not knob.numerics_preserving and not opt_in:
            # a semantics-changing value is never applied silently —
            # not even from a stored DB entry
            continue
        prev[knob.env] = os.environ.get(knob.env)
        os.environ[knob.env] = str(config.get(knob.name, knob.default))
    telemetry.set_config_fingerprint(fingerprint(current_config()))
    return prev


def restore_env(prev):
    """Undo `apply_config` (trial cleanup)."""
    from .. import telemetry

    for env, old in prev.items():
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old
    telemetry.set_config_fingerprint(None)


def fingerprint(config):
    """Stable 12-hex digest of a config dict — the telemetry
    ``config_fingerprint`` field and the tuning-DB entry id."""
    blob = json.dumps({k: str(v) for k, v in sorted(config.items())},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def program_knob_values():
    """(name, value) of layer='program' knobs — the part of the active
    config that changes the recorded step.  gluon/captured.py
    folds this into the capture cache key."""
    return tuple((k.name, k.current()) for k in KNOBS.values()
                 if k.layer == "program")
