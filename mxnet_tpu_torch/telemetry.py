"""Always-on training telemetry: the metrics registry, one record a
step, MFU accounting and a crash-safe JSONL event log.

Counterpart of ``mxnet_tpu/telemetry.py``, with the same names, record
schema (``validate_record`` is the JAX package's, unchanged) and
environment variables:

- ``MetricsRegistry``: process-wide counters, gauges and time/byte
  histograms (``count``, ``gauge_set``, ``observe``).  No device work.
- Step records: ``step_begin`` / ``on_scope`` / ``note`` / ``step_end``
  assemble one record a training step from host timers, the
  ``profiler.annotate`` scope durations (the profiler forwards each
  scope's duration here) and the step's one guard readback: wall time,
  the breakdown of the interval since the previous step (data, host
  prep, dispatch, readback, collective, other; shares sum to 1), the
  capture-cache hit, the skipped flag, FLOPs and MFU.
- MFU: the FLOPs of a captured step are counted once a capture, by
  ``count_flops`` over its eager warm-up run
  (``torch.utils.flop_counter.FlopCounterMode``, plus the formula each
  flash-attention kernel launch adds through ``add_kernel_flops``, which
  the counter cannot see); ``peak_flops`` divides by the card's bf16 peak
  from ``PEAK_FLOPS`` (``MXTPU_PEAK_FLOPS`` overrides).
- Event log: append-only JSONL at ``MXTPU_TELEMETRY_PATH``, one
  run-stamped line a record, flushed at once; a crash mid-append leaves
  every earlier line parseable.  ``MXTPU_TELEMETRY_MAX_MB`` rotates the
  sink to ``<path>.1``; ``tail_records`` reads a log incrementally across
  a rotation (the collector's read path).  Without a path the records
  land in a bounded in-memory ring (``recent_steps()``).

``MXTPU_TELEMETRY=0`` makes every hook a no-op.  Nothing here adds a
device dispatch or a host readback.
"""

from __future__ import annotations

import json
import os
import threading
import time

_LOCK = threading.Lock()

# The schema history is the JAX package's; the port writes version 8.
# v2 (autotune): step records gain optional ``tuning_trial`` (bool) and
# ``config_fingerprint`` (str) fields; v1 records stay valid.
# v3 (fleet observability): every record may carry ``rank`` / ``world``
# / ``replica_id`` identity fields, and request records may carry a
# ``trace_id`` plus a closed ``spans`` tree (obs/spans.py); v1/v2
# records stay valid.
# v4 (integrity plane): new ``integrity`` record type — one attestation
# round per record: {step, fp, ok} plus optional {epoch, peers,
# corrupt, kind}; v1/v2/v3 records stay valid.
# v5 (pipeline parallelism): step records may carry ``bubble_fraction``
# (the 1F1B schedule's idle share, in [0, 1)) next to mfu, and
# ``collective_bytes_by_axis`` may grow a ``pp`` row; v1–v4 records
# stay valid.
# v6 (sparse embeddings): step records may carry ``lookup_us`` (host
# id-prep time of a captured sparse step, microseconds, >= 0) and
# ``unique_fraction`` (unique ids / total ids, in (0, 1]); v1–v5
# records stay valid.
# v7 (resumable input pipeline): step records may carry
# ``samples_seen`` (global samples delivered to training so far, a
# non-negative int), and the event stream gains ``data_resume`` /
# ``batch_quarantined`` / ``data_worker_timeout`` kinds; v1–v6 records
# stay valid.
# v8 (split-brain fencing): step records may carry ``gang_epoch`` (the
# committed elastic-gang epoch the step ran under, a non-negative
# int), and the event stream gains ``fencing_rejected`` /
# ``ckpt_fenced`` / ``gang_fenced`` / ``partition_healed`` kinds;
# v1–v7 records stay valid.
SCHEMA_VERSION = 8
_ACCEPTED_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8)

# autotune trial marking (the autotune runner): while a trial
# config is being timed every step record is stamped
# ``tuning_trial: true`` so steady-state consumers (recent_steps
# default, trace_report aggregates, bench) exclude it; outside trials
# an applied tuned config still stamps its fingerprint.
_TRIAL_FP = None
_CONFIG_FP = None


def trial_begin(config_fingerprint):
    """Mark subsequent step records as autotune trial steps."""
    global _TRIAL_FP
    _TRIAL_FP = str(config_fingerprint)


def trial_end():
    global _TRIAL_FP
    _TRIAL_FP = None


def set_config_fingerprint(config_fingerprint):
    """Stamp steady-state step records with the applied (tuned) config
    fingerprint; None clears."""
    global _CONFIG_FP
    _CONFIG_FP = None if config_fingerprint is None \
        else str(config_fingerprint)


# the committed elastic-gang epoch this process last adopted (schema
# v8); stamped onto step records so a post-hoc reader can tell which
# membership a step ran under — the forensic trail for fencing audits.
_GANG_EPOCH = None


def set_gang_epoch(epoch):
    """Stamp subsequent step records with the adopted gang epoch
    (schema v8 ``gang_epoch``); None clears."""
    global _GANG_EPOCH
    _GANG_EPOCH = None if epoch is None else int(epoch)

#: bf16 dense peak FLOP/s by device-name substring (public data sheets),
#: matched in order against ``torch.cuda.get_device_name()``, lower case.
#: The ``cpu`` entry is the JAX package's nominal host figure, so a CPU
#: "MFU" is a relative number, not a claim.  ``MXTPU_PEAK_FLOPS``
#: overrides everything.
PEAK_FLOPS = [
    ("h100", 989e12), ("h200", 989e12), ("h800", 989e12),
    ("a100", 312e12), ("l40s", 362e12), ("a10", 125e12),
    ("cpu", 2e11),
]

_BREAKDOWN_KEYS = ("data", "host_prep", "dispatch", "readback",
                   "collective", "other")

#: profiler.annotate scope name -> breakdown bucket.  ``h2d_prefetch``
#: is deliberately absent: it runs on the prefetcher's producer thread,
#: overlapped with compute, so adding it would double-count wall time
#: (it is reported separately via the ``input.wait_us`` counter).
_SCOPE_BUCKET = {
    "captured_data": "data",
    "captured_host_prep": "host_prep",
    "captured_step": "dispatch",
    "optimizer_update": "dispatch",
    "guard_readback": "readback",
    "allreduce": "collective",
    "bucket_pack": "collective",
}


def enabled() -> bool:
    """MXTPU_TELEMETRY gate (default on); 0/false/off makes every hook
    in this module a no-op."""
    return os.environ.get("MXTPU_TELEMETRY", "1").lower() \
        not in ("0", "false", "off", "")


def telemetry_path():
    """MXTPU_TELEMETRY_PATH: JSONL sink for step records and events;
    unset = in-memory ring only (`recent_steps()`)."""
    return os.environ.get("MXTPU_TELEMETRY_PATH") or None


# -- metrics registry ----------------------------------------------------------

class Counter:
    """Monotonic counter (steps, bytes, accumulated wait time)."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        with _LOCK:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, loss scale)."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = None

    def set(self, v):
        self.value = v


class Histogram:
    """Time/byte distribution: count, total, min, max (the same shape
    as the profiler's aggregate table — enough for stall attribution
    without per-sample storage)."""

    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, v):
        with _LOCK:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def summary(self):
        return {"count": self.count, "total": self.total,
                "min": self.min if self.count else None, "max": self.max}


class MetricsRegistry:
    """Process-wide named-metric store.  `counter`/`gauge`/`histogram`
    create-or-return; `snapshot()` is the read surface the per-step
    assembler and tests use."""

    def __init__(self):
        self._metrics = {}

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            with _LOCK:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        out = {}
        for name, m in list(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def reset(self):
        with _LOCK:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


def count(name, n=1):
    """Shorthand hook for hot paths: no-op when telemetry is off."""
    if enabled():
        REGISTRY.counter(name).inc(n)


def gauge_set(name, v):
    if enabled():
        REGISTRY.gauge(name).set(v)


def observe(name, v):
    if enabled():
        REGISTRY.histogram(name).observe(v)


# -- run identity and the JSONL sink -------------------------------------------

_RUN_ID = f"{os.getpid():x}-{int(time.time() * 1000) & 0xffffffff:08x}"
_SINK = None          # (path, file object)
_SINK_SIZE = 0        # bytes written to the current sink file
_RECENT = []          # bounded ring of records (recent_steps reads it)
_RECENT_MAX = 256
_EVENT_COUNTS = {}    # event kind -> count (cheap test/report surface)


def run_id() -> str:
    return _RUN_ID


# -- fleet identity (schema v3) ------------------------------------------------
#
# Every record is stamped with the emitting process's place in the
# fleet so the obs collector can aggregate per-rank logs into one
# FleetView.  Identity resolves lazily from MXTPU_WORKER_RANK /
# MXTPU_NUM_WORKERS and is overridden explicitly by ElasticGang /
# ReplicaServer via set_identity() (reshapes update world in place).
# The dict is cached: stamping costs two dict lookups per record,
# invisible against the <1% overhead budget.

_IDENT = None


def _identity() -> dict:
    global _IDENT
    if _IDENT is None:
        ident = {}
        try:
            r = os.environ.get("MXTPU_WORKER_RANK")
            w = os.environ.get("MXTPU_NUM_WORKERS")
            if r is not None:
                ident["rank"] = int(r)
            if w is not None:
                ident["world"] = int(w)
        except ValueError:
            ident = {}
        _IDENT = ident
    return _IDENT


def set_identity(rank=None, world=None, replica_id=None):
    """Declare this process's fleet identity; subsequent records carry
    the fields.  Partial updates merge (a reshape only changes world)."""
    global _IDENT
    ident = dict(_identity())
    if rank is not None:
        ident["rank"] = int(rank)
    if world is not None:
        ident["world"] = int(world)
    if replica_id is not None:
        ident["replica_id"] = int(replica_id)
    _IDENT = ident


def identity() -> dict:
    """The current identity stamp (possibly empty) — read surface for
    obs/collector.py and tests."""
    return dict(_identity())


def _sink_file():
    """Lazily opened append-only JSONL file; reopened if the configured
    path changes (tests point it at per-test tmp dirs)."""
    global _SINK, _SINK_SIZE
    path = telemetry_path()
    with _LOCK:
        if path is None:
            if _SINK is not None:
                try:
                    _SINK[1].close()
                except OSError:
                    pass
                _SINK = None
            return None
        if _SINK is None or _SINK[0] != path:
            if _SINK is not None:
                try:
                    _SINK[1].close()
                except OSError:
                    pass
            f = open(path, "a", encoding="utf-8")
            _SINK = (path, f)
            try:
                _SINK_SIZE = os.path.getsize(path)
            except OSError:
                _SINK_SIZE = 0
        return _SINK[1]


def _max_sink_bytes():
    """MXTPU_TELEMETRY_MAX_MB → byte cap on the JSONL sink, or None
    (unbounded, the default)."""
    raw = os.environ.get("MXTPU_TELEMETRY_MAX_MB")
    if not raw:
        return None
    try:
        mb = float(raw)
    except ValueError:
        return None
    return int(mb * 1e6) if mb > 0 else None


def _rotate_locked(res):
    """Rotate the sink: close, rename to ``<path>.1`` (atomic on the
    same filesystem), reopen fresh.  Caller holds _LOCK.  The
    ``telemetry_rotate`` fault site crashes BETWEEN the rename and the
    reopen — the torn-rotation window readers must survive (``.1``
    complete, the live path momentarily absent)."""
    global _SINK, _SINK_SIZE
    path, f = _SINK
    try:
        f.close()
    except OSError:
        pass
    try:
        os.replace(path, path + ".1")
    except OSError:
        pass               # rename failure: keep appending in place
    if res is not None and res.consume_fault("telemetry_rotate"):
        os._exit(res.CRASH_EXIT_CODE)
    nf = open(path, "a", encoding="utf-8")
    _SINK = (path, nf)
    _SINK_SIZE = 0
    return nf


def _emit(record):
    """Append one record to the ring and (when configured) the JSONL
    log.  One line per record, flushed immediately: a crash between
    records loses nothing, a crash mid-write truncates only the last
    line (readers skip it).  When MXTPU_TELEMETRY_MAX_MB is set the
    sink rotates to ``<path>.1`` before the write that would cross the
    cap."""
    global _SINK_SIZE
    for k, v in _identity().items():
        record.setdefault(k, v)
    with _LOCK:
        _RECENT.append(record)
        del _RECENT[:-_RECENT_MAX]
    f = _sink_file()
    if f is None:
        return
    line = json.dumps(record, separators=(",", ":")) + "\n"
    try:
        from . import resilience as _res
    except ImportError:        # loaded as a standalone module
        _res = None
    with _LOCK:
        cap = _max_sink_bytes()
        if cap is not None and _SINK_SIZE > 0 \
                and _SINK_SIZE + len(line) > cap:
            f = _rotate_locked(_res)
        if _res is not None and _res.consume_fault("telemetry_crash"):
            # hermetic crash-mid-append: half a line, then power loss
            f.write(line[:max(1, len(line) // 2)])
            f.flush()
            os._exit(_res.CRASH_EXIT_CODE)
        try:
            f.write(line)
            f.flush()
            _SINK_SIZE += len(line)
        except OSError:
            pass               # telemetry must never kill training


# -- incremental JSONL tailing (obs/collector.py polls these) ------------------
#
# The collector re-reads the per-rank logs every MXTPU_OBS_ROLLUP_SECS;
# a full re-parse would be O(log size) per poll.  Each tailed path
# keeps a seek offset so a poll costs O(new bytes) — pinned by
# tests/test_obs.py via tail_bytes_read().  Rotation (the sink moving
# to ``<path>.1`` under the reader) is detected by inode change or
# shrink; the remainder of the rotated file is drained from the old
# offset before the fresh file is read from 0, so no record is lost
# across the boundary — including the torn-rotation window where the
# live path briefly does not exist.

_TAILS = {}           # path -> {"off", "ino", "r1_off"}
_TAIL_RINGS = {}      # path -> bounded list of parsed records
_TAIL_BYTES = 0       # total bytes read by _read_lines (test pin)
_TAIL_STRIKES = {}    # path -> [tail_start, tail_len, polls_held]


def _tail_strikes_max(default=3) -> int:
    """MXTPU_TELEMETRY_TAIL_STRIKES: polls the SAME half-flushed tail
    may be held back before it is skipped as torn (default 3)."""
    try:
        v = int(os.environ.get("MXTPU_TELEMETRY_TAIL_STRIKES", default))
    except ValueError:
        v = default
    return max(2, v)


def _tail_strike(path, tail_start, tail_len, new_off):
    """Torn-tail strike accounting.  A half-flushed line is normally
    held back (re-read next poll) until its newline lands — but a line
    that NEVER completes (writer died mid-append, bit-rot ate the
    newline) would otherwise wedge the tail forever, silently.  After
    the identical byte range is held back ``_tail_strikes_max()``
    polls in a row, skip past it and emit one ``telemetry_torn_line``
    event so the corruption is visible.  A growing tail (len changes)
    resets the count — only a genuinely stuck line strikes out."""
    st = _TAIL_STRIKES.get(path)
    if st is not None and st[0] == tail_start and st[1] == tail_len:
        st[2] += 1
    else:
        st = _TAIL_STRIKES[path] = [tail_start, tail_len, 1]
    if st[2] < _tail_strikes_max():
        return new_off
    del _TAIL_STRIKES[path]
    event("telemetry_torn_line", path=os.path.basename(path),
          offset=int(tail_start), bytes=int(tail_len))
    return tail_start + tail_len


def tail_bytes_read() -> int:
    return _TAIL_BYTES


def _read_lines(path, start):
    """Parse complete JSONL lines from `path` starting at byte
    `start`; returns (records, new_offset).  The offset only advances
    past the last newline, so a half-flushed tail is re-read (not
    skipped) on the next poll."""
    global _TAIL_BYTES
    try:
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read()
    except OSError:
        return [], start
    if not data:
        return [], start
    _TAIL_BYTES += len(data)
    nl = data.rfind(b"\n")
    if nl < 0:
        return [], _tail_strike(path, start, len(data), start)
    recs = []
    for raw in data[:nl + 1].splitlines():
        try:
            recs.append(json.loads(raw))
        except ValueError:
            pass               # torn line mid-file (crash artifact)
    new_off = start + nl + 1
    tail = len(data) - (nl + 1)
    if tail:
        new_off = _tail_strike(path, new_off, tail, new_off)
    else:
        _TAIL_STRIKES.pop(path, None)
    return recs, new_off


def tail_records(path):
    """Newly appended records of `path` since the previous call
    (per-path seek offset; O(new bytes)), reading across a sink
    rotation without loss."""
    st = _TAILS.get(path)
    if st is None:
        # bootstrap: an already-rotated predecessor (including the
        # torn-rotation case where the live path does not exist yet)
        # is drained before the live file, oldest records first
        st = _TAILS[path] = {
            "off": 0, "ino": None,
            "r1_off": 0 if os.path.exists(path + ".1") else None}
    try:
        s = os.stat(path)
        size, ino = s.st_size, s.st_ino
    except OSError:
        size = ino = None
    rotated = (
        (size is None and st["off"] > 0) or
        (size is not None and size < st["off"]) or
        (ino is not None and st["ino"] is not None and ino != st["ino"]))
    out = []
    if rotated:
        # what we were reading is now <path>.1: drain its remainder
        if st["r1_off"] is None:
            st["r1_off"] = st["off"]
        st["off"] = 0
        st["ino"] = None
    if st["r1_off"] is not None:
        recs, new_off = _read_lines(path + ".1", st["r1_off"])
        out.extend(recs)
        # keep tracking .1 only while the live file is absent (torn
        # rotation); once it exists the rotated file is frozen
        st["r1_off"] = new_off if size is None else None
    if size is not None:
        recs, st["off"] = _read_lines(path, st["off"])
        st["ino"] = ino
        out.extend(recs)
    return out


def _tail_ring(path):
    ring = _TAIL_RINGS.get(path)
    if ring is None:
        ring = _TAIL_RINGS[path] = []
    new = tail_records(path)
    if new:
        ring.extend(new)
        del ring[:-_RECENT_MAX]
    return ring


def recent_steps(path=None, include_trials=False, jsonl=None):
    """Step records, oldest first (optionally filtered by step path:
    'captured' / 'eager' / 'manual').  Default source is the in-memory
    ring; pass ``jsonl=`` to incrementally tail a JSONL log instead
    (O(new lines) per call — the collector's read path).  Autotune
    trial steps are EXCLUDED by default: they time candidate configs,
    not the run's steady state (pass include_trials=True to see them)."""
    if jsonl is not None:
        recs = [r for r in _tail_ring(jsonl) if r.get("type") == "step"]
    else:
        with _LOCK:
            recs = [r for r in _RECENT if r.get("type") == "step"]
    if not include_trials:
        recs = [r for r in recs if not r.get("tuning_trial")]
    if path is not None:
        recs = [r for r in recs if r.get("path") == path]
    return recs


def event_counts() -> dict:
    with _LOCK:
        return dict(_EVENT_COUNTS)


def reset(close_sink=True):
    """Drop the registry, ring, event counts, inter-step state, and
    (optionally) the sink handle: test isolation, not a runtime API."""
    global _SINK, _SINK_SIZE, _LAST_END, _LAST_COUNTS, _CURRENT
    global _PEAK_CACHE, _TRIAL_FP, _CONFIG_FP, _IDENT, _TAIL_BYTES
    global _GANG_EPOCH
    with _LOCK:
        _RECENT.clear()
        _EVENT_COUNTS.clear()
    REGISTRY.reset()
    _CURRENT = None
    _TRIAL_FP = None
    _CONFIG_FP = None
    _GANG_EPOCH = None
    _LAST_END = None
    _LAST_COUNTS = {}
    _PEAK_CACHE = None
    _IDENT = None
    _TAILS.clear()
    _TAIL_RINGS.clear()
    _TAIL_STRIKES.clear()
    _TAIL_BYTES = 0
    _SINK_SIZE = 0
    if close_sink and _SINK is not None:
        try:
            _SINK[1].close()
        except OSError:
            pass
        _SINK = None


def event(kind, /, **fields):
    """Emit one discrete, run-id-stamped event record (watchdog fired,
    step skipped, divergence rollback, restart, checkpoint commit).
    The event name is positional-only so a detail field may itself be
    named ``kind`` (e.g. sdc_detected's corruption class)."""
    if not enabled():
        return
    rec = {"type": "event", "v": SCHEMA_VERSION, "run": _RUN_ID,
           "t": time.time(), "event": str(kind)}
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    with _LOCK:
        _EVENT_COUNTS[kind] = _EVENT_COUNTS.get(kind, 0) + 1
    _emit(rec)


def request_record(queue_us, prefill_us, decode_us_per_token, bucket,
                   padded_fraction, new_tokens=None, generation=None,
                   **fields):
    """Emit one per-request serving record (the serving analogue of a
    StepStats row): queue wait, prefill latency, per-token decode
    latency, the (batch, seq) bucket the request was padded into, and
    the padding overhead it paid."""
    if not enabled():
        return
    rec = {"type": "request", "v": SCHEMA_VERSION, "run": _RUN_ID,
           "t": time.time(),
           "queue_us": round(float(queue_us), 1),
           "prefill_us": round(float(prefill_us), 1),
           "decode_us_per_token": round(float(decode_us_per_token), 1),
           "bucket": [int(b) for b in bucket],
           "padded_fraction": float(padded_fraction)}
    if new_tokens is not None:
        rec["new_tokens"] = int(new_tokens)
    if generation is not None:
        rec["generation"] = int(generation)
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    _emit(rec)


def integrity_record(step, fp, ok, epoch=None, peers=None, corrupt=None,
                     kind=None, rank=None, **fields):
    """Emit one integrity-attestation record (schema v4): the
    fingerprint this rank published for ``step``, whether the
    cross-replica vote agreed (``ok``), how many peers voted, which
    ranks the majority named corrupt, and — after a replay audit — the
    corruption ``kind`` ("memory" | "compute" | "drift").  The obs
    collector counts these."""
    if not enabled():
        return
    rec = {"type": "integrity", "v": SCHEMA_VERSION, "run": _RUN_ID,
           "t": time.time(), "step": int(step), "fp": str(fp),
           "ok": bool(ok)}
    if epoch is not None:
        rec["epoch"] = int(epoch)
    if peers is not None:
        rec["peers"] = int(peers)
    if corrupt:
        rec["corrupt"] = [int(r) for r in corrupt]
    if kind is not None:
        rec["kind"] = str(kind)
    if rank is not None:
        rec["rank"] = int(rank)
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    _emit(rec)


def recent_requests(jsonl=None):
    """Per-request serving records, oldest first: the in-memory ring,
    or (with ``jsonl=``) an incrementally tailed JSONL log."""
    if jsonl is not None:
        return [r for r in _tail_ring(jsonl) if r.get("type") == "request"]
    with _LOCK:
        return [r for r in _RECENT if r.get("type") == "request"]


# -- per-step assembly ---------------------------------------------------------

#: counters whose per-step DELTA lands in each StepStats record
_DELTA_COUNTERS = ("collective.bytes", "collective.buckets",
                   "input.wait_us", "ckpt.stall_us")

_CURRENT = None       # open _StepAccum, at most one per process
_LAST_END = None      # perf_counter at the previous step_end
_LAST_COUNTS = {}     # counter snapshot at the previous step_end


class _StepAccum:
    """Accumulator for one in-flight step (returned by `step_begin`)."""

    __slots__ = ("t0", "tid", "path", "scopes", "fields")

    def __init__(self, path):
        self.t0 = time.perf_counter()
        self.tid = threading.get_ident()
        self.path = path
        self.scopes = {}
        self.fields = {}


def step_begin(path="eager"):
    """Open the per-step accumulator; returns None when telemetry is off
    or a step is already open (nested Trainer.step inside train_step)."""
    global _CURRENT
    if not enabled() or _CURRENT is not None:
        return None
    _CURRENT = _StepAccum(path)
    return _CURRENT


def on_scope(name, dur_s):
    """Profiler scope hook: `profiler.scope.__exit__` forwards every
    annotate duration here.  Only scopes on the step-owning thread count
    toward the breakdown (producer-thread work overlaps compute)."""
    acc = _CURRENT
    if acc is None or threading.get_ident() != acc.tid:
        return
    acc.scopes[name] = acc.scopes.get(name, 0.0) + dur_s


def step_abort(acc):
    """Discard an open accumulator without emitting (step raised): the
    next step_begin must not find a stale open record."""
    global _CURRENT
    if acc is not None and acc is _CURRENT:
        _CURRENT = None


def note(**fields):
    """Attach fields (grad_norm, loss_scale, flops, cache_hit, ...) to
    the currently open step record; no-op when none is open."""
    acc = _CURRENT
    if acc is None:
        return
    for k, v in fields.items():
        if v is not None:
            acc.fields[k] = v


def note_path(path):
    acc = _CURRENT
    if acc is not None:
        acc.path = path


def step_end(acc, step=None, skipped=False):
    """Close the accumulator into one StepStats record and emit it.

    The breakdown interval is ``now - previous step_end`` (first step:
    ``now - step_begin``) so the wait for the NEXT batch — which happens
    between `train_step` calls — is attributed to the step it stalled.
    Shares, including ``other``, sum to 1.0 over that interval.
    """
    global _CURRENT, _LAST_END, _LAST_COUNTS
    if acc is None or acc is not _CURRENT:
        return None
    _CURRENT = None
    now = time.perf_counter()
    wall_us = (now - acc.t0) * 1e6
    start = _LAST_END if _LAST_END is not None else acc.t0
    interval_us = max((now - start) * 1e6, wall_us, 1e-3)
    # lock-free metric reads (dict.get is atomic; a missing metric just
    # means no traffic yet) — this runs once per training step
    metrics = REGISTRY._metrics
    counts = {}
    deltas = {}
    for name in _DELTA_COUNTERS:
        m = metrics.get(name)
        counts[name] = v = m.value if m is not None else 0
        deltas[name] = v - _LAST_COUNTS.get(name, 0)
    _LAST_END = now
    _LAST_COUNTS = counts

    parts = dict.fromkeys(_BREAKDOWN_KEYS[:-1], 0.0)
    for scope_name, dur in acc.scopes.items():
        bucket = _SCOPE_BUCKET.get(scope_name)
        if bucket is not None:
            parts[bucket] += dur * 1e6
    parts["data"] += deltas["input.wait_us"]
    known = sum(parts.values())
    parts["other"] = max(interval_us - known, 0.0)
    total = sum(parts.values()) or 1.0

    rec = {
        "type": "step", "v": SCHEMA_VERSION, "run": _RUN_ID,
        "t": time.time(),
        "step": int(step) if step is not None else None,
        "path": acc.path,
        "skipped": bool(skipped),
        # deliberately un-rounded: 16 round() calls cost ~6us/step,
        # a third of the whole mechanism's overhead budget
        "wall_us": wall_us,
        "interval_us": interval_us,
        "breakdown_us": parts,
        "shares": {k: v / total for k, v in parts.items()},
        "collective_bytes": int(deltas["collective.bytes"]),
        "collective_buckets": int(deltas["collective.buckets"]),
        "ckpt_stall_us": deltas["ckpt.stall_us"],
        "input_queue_depth": getattr(
            metrics.get("input.queue_depth"), "value", None),
    }
    flops = acc.fields.pop("flops", None)
    rec["flops"] = flops
    mfu = None
    if flops:
        peak = peak_flops()
        if peak:
            mfu = flops / (interval_us * 1e-6) / peak
    rec["mfu"] = round(mfu, 6) if mfu is not None else None
    if _TRIAL_FP is not None:
        rec["tuning_trial"] = True
        rec["config_fingerprint"] = _TRIAL_FP
    elif _CONFIG_FP is not None:
        rec["config_fingerprint"] = _CONFIG_FP
    if _GANG_EPOCH is not None:
        rec["gang_epoch"] = _GANG_EPOCH
    for k, v in acc.fields.items():
        rec[k] = v
    _emit(rec)
    return rec


# -- MFU accounting ------------------------------------------------------------

_PEAK_CACHE = None


def peak_flops():
    """Peak FLOP/s of the step's device: the MXTPU_PEAK_FLOPS override,
    else the ``PEAK_FLOPS`` entry of the first visible card's name (of
    ``cpu`` without a card).  None for an unknown card: MFU is then
    reported as null, not against a made-up denominator."""
    global _PEAK_CACHE
    # the override resolves into the cache too (cleared by reset()): this
    # runs once a step
    if _PEAK_CACHE is not None:
        return _PEAK_CACHE or None
    raw = os.environ.get("MXTPU_PEAK_FLOPS")
    if raw:
        try:
            val = float(raw)
            if val > 0:
                _PEAK_CACHE = val
                return val
        except ValueError:
            pass
    try:
        import torch

        kind = torch.cuda.get_device_name(0).lower() \
            if torch.cuda.is_available() else "cpu"
    except Exception:
        return None
    val = 0.0
    for key, v in PEAK_FLOPS:
        if key in kind:
            val = v
            break
    _PEAK_CACHE = val
    return val or None


def flops_of_compiled(compiled):
    """Total FLOPs from an object's ``cost_analysis()`` (a dict, or a
    list of one, with a ``flops`` entry), or None when it reports none.
    The port's steps count theirs with ``count_flops``."""
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else None
        if not ca:
            return None
        flops = ca.get("flops")
        return float(flops) if flops and flops > 0 else None
    except Exception:
        return None


_KERNEL_FLOPS = None   # running tally while count_flops is open, else None


def add_kernel_flops(n):
    """Credit ``n`` FLOPs of a hand-written kernel launch (which
    ``FlopCounterMode`` cannot see) to an open ``count_flops``; a no-op
    otherwise."""
    tally = _KERNEL_FLOPS
    if tally is not None:
        tally[0] += n


def count_flops(fn):
    """Run ``fn()`` once under ``torch.utils.flop_counter.FlopCounterMode``
    and return ``(fn's result, total FLOPs)``: the counter's matmul and
    convolution FLOPs plus what the kernels' wrappers credited through
    ``add_kernel_flops``.  The FLOPs are None when nothing was counted."""
    global _KERNEL_FLOPS
    from torch.utils.flop_counter import FlopCounterMode

    tally = [0]
    prev, _KERNEL_FLOPS = _KERNEL_FLOPS, tally
    try:
        with FlopCounterMode(display=False) as counter:
            out = fn()
    finally:
        _KERNEL_FLOPS = prev
    total = float(counter.get_total_flops() + tally[0])
    return out, (total if total > 0 else None)


_COLLECTIVE_RE = None


def collective_bytes_by_axis(compiled, mesh):
    """Per-device bytes moved by a step program's collectives,
    attributed to mesh axes: ``{"dp": ..., "tp": ..., "all": ...}``.

    ``compiled`` is anything with ``as_text()`` returning HLO text (the
    JAX package's compiled programs; the port's one-card steps have none
    and report no collectives); ``mesh`` anything with ``axis_names``,
    ``shape`` (name -> size) and ``size``.  Parses the HLO text for `all-reduce` / `all-gather` /
    `reduce-scatter` / `all-to-all` / `collective-permute` ops, reads
    each op's replica groups, and attributes the op to the mesh axis
    whose size matches the group size (group stride breaking ties:
    contiguous groups are inner axes, strided groups outer; tp is
    innermost by `make_mesh`'s canonical order).  Bytes use the ring
    cost model per participating device: ``2(S-1)/S·bytes`` for
    all-reduce, ``(S-1)/S·bytes`` for all-gather / reduce-scatter /
    all-to-all, ``1·bytes`` for collective-permute.  Returns {} when
    the HLO is unavailable or parses to nothing — callers treat that
    as "no data", never as "zero collectives".
    """
    global _COLLECTIVE_RE
    import re as _re

    if _COLLECTIVE_RE is None:
        _COLLECTIVE_RE = _re.compile(
            r"=\s*(?P<shape>.+?)\s+"
            r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|"
            r"collective-permute)(?:-start)?\(")
    try:
        hlo = compiled.as_text()
    except Exception:
        return {}
    if not hlo:
        return {}

    dtype_bytes = {
        "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
        "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
        "s32": 4, "u32": 4, "f32": 4,
        "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    }
    shape_re = _re.compile(r"(\w+)\[([\d,]*)\]")

    def bytes_of(shape_txt):
        total = 0
        for dt, dims in shape_re.findall(shape_txt):
            nb = dtype_bytes.get(dt)
            if nb is None:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * nb
        return total

    # axis sizes and strides in the mesh's device array: innermost axis
    # has stride 1, so a CONTIGUOUS replica group ({0,1},{2,3},...) of
    # size S belongs to the innermost axis of that size
    names = list(mesh.axis_names)
    sizes = [mesh.shape[n] for n in names]
    strides = {}
    acc = 1
    for n, s in zip(reversed(names), reversed(sizes)):
        strides[n] = acc
        acc *= s

    def axis_of(group_size, contiguous):
        if group_size >= mesh.size:
            return "all"
        cands = [n for n in names if mesh.shape[n] == group_size]
        if not cands:
            return "other"
        if len(cands) == 1:
            return cands[0]
        # tie: contiguous groups ⇒ smallest stride (innermost axis)
        key = (lambda n: strides[n]) if contiguous \
            else (lambda n: -strides[n])
        return sorted(cands, key=key)[0]

    out = {}
    for line in hlo.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if m is None or "-done" in line[:m.start()]:
            continue
        op = m.group("op")
        shape_txt = m.group("shape")
        group_size, contiguous = mesh.size, True
        gm = _re.search(r"replica_groups=\{(\{[\d,]+\})", line)
        if gm is not None:
            first = [int(x) for x in
                     gm.group(1).strip("{}").split(",") if x]
            group_size = max(len(first), 1)
            contiguous = all(b - a == 1
                             for a, b in zip(first, first[1:]))
        else:
            gm = _re.search(
                r"replica_groups=\[(\d+),(\d+)\]<=\[[\d,]+\](T\()?",
                line)
            if gm is not None:
                group_size = max(int(gm.group(2)), 1)
                contiguous = gm.group(3) is None
        s = group_size
        nbytes = bytes_of(shape_txt)
        if op == "all-reduce":
            moved = 2.0 * (s - 1) / s * nbytes
        elif op == "collective-permute":
            moved = float(nbytes)
        else:
            # all-gather bytes from the RESULT shape, reduce-scatter
            # from the operand — the printed shape is the result either
            # way; for reduce-scatter the operand is S× the result, so
            # (S-1)/S·operand == (S-1)·result
            if op == "reduce-scatter":
                moved = float(s - 1) * nbytes
            else:
                moved = (s - 1) / s * nbytes
        axis = axis_of(s, contiguous)
        out[axis] = out.get(axis, 0) + int(moved)
    return out


# -- schema validation ---------------------------------------------------------

def _validate_spans(spans, fail):
    """A request's ``spans`` field must be one CLOSED causal tree:
    every span has an id/name/t0/dur_us, exactly one root (parent
    null), and every parent id resolves inside the list."""
    if not isinstance(spans, list) or not spans:
        fail("spans must be a non-empty list")
    ids = set()
    roots = 0
    for sp in spans:
        if not isinstance(sp, dict):
            fail("each span must be an object")
        sid = sp.get("span_id")
        if not isinstance(sid, str) or not sid:
            fail("span_id must be a non-empty string")
        if sid in ids:
            fail(f"duplicate span_id {sid!r}")
        ids.add(sid)
        if not isinstance(sp.get("name"), str) or not sp["name"]:
            fail("span name must be a non-empty string")
        if not isinstance(sp.get("t0"), (int, float)):
            fail("span t0 must be a number (epoch seconds)")
        dur = sp.get("dur_us")
        if not isinstance(dur, (int, float)) or dur < 0:
            fail("span dur_us must be a non-negative number "
                 "(open spans may not be emitted)")
        if sp.get("parent") is None:
            roots += 1
    if roots != 1:
        fail(f"spans must have exactly one root, got {roots}")
    for sp in spans:
        parent = sp.get("parent")
        if parent is not None and parent not in ids:
            fail(f"span parent {parent!r} not in tree")


def validate_record(rec):
    """Raise ValueError unless `rec` is a well-formed telemetry record.
    The schema is the JAX package's (``mxnet_tpu/telemetry.py``)."""

    def fail(msg):
        raise ValueError(f"telemetry record invalid: {msg}; record={rec!r}")

    if not isinstance(rec, dict):
        fail("not an object")
    kind = rec.get("type")
    if kind not in ("step", "event", "request", "integrity"):
        fail(f"type must be 'step'|'event'|'request'|'integrity', "
             f"got {kind!r}")
    if not isinstance(rec.get("run"), str) or not rec["run"]:
        fail("missing run id")
    if not isinstance(rec.get("t"), (int, float)):
        fail("missing timestamp t")
    if rec.get("v") not in _ACCEPTED_VERSIONS:
        fail(f"schema version {rec.get('v')!r} not in "
             f"{_ACCEPTED_VERSIONS}")
    # optional fleet-identity fields (schema v3): any record type
    for key, lo in (("rank", 0), ("world", 1), ("replica_id", 0)):
        val = rec.get(key)
        if val is not None and (not isinstance(val, int) or
                                isinstance(val, bool) or val < lo):
            fail(f"{key} must be an int >= {lo} or absent")
    if kind == "request":
        tid = rec.get("trace_id")
        if tid is not None and (not isinstance(tid, str) or not tid):
            fail("trace_id must be a non-empty string or absent")
        spans = rec.get("spans")
        if spans is not None:
            _validate_spans(spans, fail)
        for key in ("queue_us", "prefill_us", "decode_us_per_token"):
            val = rec.get(key)
            if not isinstance(val, (int, float)) or val < 0:
                fail(f"{key} must be a non-negative number")
        bucket = rec.get("bucket")
        if not (isinstance(bucket, list) and len(bucket) == 2 and
                all(isinstance(b, int) and b > 0 for b in bucket)):
            fail("bucket must be [batch, seq] positive ints")
        pf = rec.get("padded_fraction")
        if not isinstance(pf, (int, float)) or not 0 <= pf < 1:
            fail("padded_fraction must be a number in [0, 1)")
        for key in ("new_tokens", "generation"):
            val = rec.get(key)
            if val is not None and \
                    (not isinstance(val, int) or val < 0):
                fail(f"{key} must be a non-negative int or absent")
        de = rec.get("deadline_exceeded")
        if de is not None and not isinstance(de, bool):
            fail("deadline_exceeded must be a bool or absent")
        return rec
    if kind == "event":
        if not isinstance(rec.get("event"), str) or not rec["event"]:
            fail("event record missing event kind")
        step = rec.get("step")
        if step is not None and not isinstance(step, int):
            fail("event step must be an int")
        return rec
    if kind == "integrity":
        # schema v4: one attestation round
        step = rec.get("step")
        if not isinstance(step, int) or isinstance(step, bool) or \
                step < 0:
            fail("integrity step must be a non-negative int")
        fp = rec.get("fp")
        if not isinstance(fp, str) or not fp:
            fail("integrity fp must be a non-empty string")
        if not isinstance(rec.get("ok"), bool):
            fail("integrity ok must be a bool")
        for key in ("epoch", "peers"):
            val = rec.get(key)
            if val is not None and (not isinstance(val, int) or
                                    isinstance(val, bool) or val < 0):
                fail(f"integrity {key} must be a non-negative int "
                     f"or absent")
        corrupt = rec.get("corrupt")
        if corrupt is not None and not (
                isinstance(corrupt, list) and
                all(isinstance(r, int) and not isinstance(r, bool)
                    and r >= 0 for r in corrupt)):
            fail("integrity corrupt must be a list of ranks or absent")
        ik = rec.get("kind")
        if ik is not None and ik not in ("memory", "compute", "drift"):
            fail(f"integrity kind must be memory|compute|drift, "
                 f"got {ik!r}")
        return rec
    if rec.get("step") is not None and not isinstance(rec["step"], int):
        fail("step must be an int or null")
    if rec.get("path") not in ("captured", "eager", "manual"):
        fail(f"unknown path {rec.get('path')!r}")
    if not isinstance(rec.get("skipped"), bool):
        fail("skipped must be a bool")
    for key in ("wall_us", "interval_us"):
        val = rec.get(key)
        if not isinstance(val, (int, float)) or val < 0:
            fail(f"{key} must be a non-negative number")
    for section in ("breakdown_us", "shares"):
        obj = rec.get(section)
        if not isinstance(obj, dict) or \
                set(obj) != set(_BREAKDOWN_KEYS):
            fail(f"{section} must have keys {_BREAKDOWN_KEYS}")
        for k, val in obj.items():
            if not isinstance(val, (int, float)) or val < 0:
                fail(f"{section}[{k}] must be a non-negative number")
    total = sum(rec["shares"].values())
    if not 0.98 <= total <= 1.02:
        fail(f"shares sum to {total}, expected ~1.0")
    for key in ("collective_bytes", "collective_buckets"):
        if not isinstance(rec.get(key), int) or rec[key] < 0:
            fail(f"{key} must be a non-negative int")
    for key in ("flops", "mfu", "grad_norm", "loss_scale"):
        val = rec.get(key)
        if val is not None and not isinstance(val, (int, float)):
            fail(f"{key} must be a number or null")
    if rec.get("cache_hit") is not None and \
            not isinstance(rec["cache_hit"], bool):
        fail("cache_hit must be a bool or null")
    # optional autotune fields (schema v2): absent on untuned runs
    tt = rec.get("tuning_trial")
    if tt is not None and not isinstance(tt, bool):
        fail("tuning_trial must be a bool or absent")
    cfp = rec.get("config_fingerprint")
    if cfp is not None and \
            (not isinstance(cfp, str) or not cfp):
        fail("config_fingerprint must be a non-empty string or absent")
    # optional sharded-step fields: absent on unsharded runs
    cba = rec.get("collective_bytes_by_axis")
    if cba is not None:
        if not isinstance(cba, dict):
            fail("collective_bytes_by_axis must be an object or absent")
        for k, val in cba.items():
            if not isinstance(k, str) or \
                    not isinstance(val, int) or val < 0:
                fail("collective_bytes_by_axis entries must be "
                     "str → non-negative int")
    peak = rec.get("device_peak_bytes")
    if peak is not None and \
            (not isinstance(peak, (int, float)) or peak < 0):
        fail("device_peak_bytes must be a non-negative number or absent")
    # optional pipeline field (schema v5): absent off the pp schedule
    bf = rec.get("bubble_fraction")
    if bf is not None and \
            (not isinstance(bf, (int, float)) or not 0 <= bf < 1):
        fail("bubble_fraction must be a number in [0, 1) or absent")
    # optional sparse-embedding fields (schema v6): absent on dense steps
    lu = rec.get("lookup_us")
    if lu is not None and \
            (not isinstance(lu, (int, float)) or lu < 0):
        fail("lookup_us must be a non-negative number or absent")
    uf = rec.get("unique_fraction")
    if uf is not None and \
            (not isinstance(uf, (int, float)) or not 0 < uf <= 1):
        fail("unique_fraction must be a number in (0, 1] or absent")
    # optional input-pipeline field (schema v7): absent when no
    # resumable pipeline is attached to the trainer
    ss = rec.get("samples_seen")
    if ss is not None and \
            (not isinstance(ss, int) or isinstance(ss, bool) or ss < 0):
        fail("samples_seen must be a non-negative int or absent")
    # optional gang-fencing field (schema v8): absent outside an
    # elastic gang
    ge = rec.get("gang_epoch")
    if ge is not None and \
            (not isinstance(ge, int) or isinstance(ge, bool) or ge < 0):
        fail("gang_epoch must be a non-negative int or absent")
    return rec
