"""Telemetry: counters, gauges, events and per-request serving records.

Counterpart of the parts of ``mxnet_tpu/telemetry.py`` that the input
path and the serving tier call (``enabled``, ``count``, ``gauge_set``,
``event``, ``event_counts``, ``request_record``, ``recent_requests``,
``validate_record``; ``telemetry.py:147, 264-275, 607-723, 1050-1140``): a
process-wide registry of named counters and gauges, and run-stamped
records (discrete events, one record a served request with its span
tree) kept in a bounded in-memory ring and, with
``MXTPU_TELEMETRY_PATH`` set, appended to that JSONL file one line a
record.  ``MXTPU_TELEMETRY=0`` makes every hook a no-op.  No hook touches
the device.  The port's records are schema version 1 with the request
fields (``trace_id``, ``spans``, ``replica_id``) that the JAX package's
schema accepts at every version.

The rest of the module (the per-step ``StepStats`` records, histograms,
MFU, the sink's rotation, fleet identity) comes with the production
planes, ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import json
import os
import threading
import time

_LOCK = threading.Lock()

SCHEMA_VERSION = 1
_ACCEPTED_VERSIONS = (1,)

_RECENT = []          # bounded ring of records, oldest first
_RECENT_MAX = 256

_RUN_ID = f"{os.getpid():x}-{int(time.time() * 1000) & 0xffffffff:08x}"
_EVENT_COUNTS = {}    # event kind -> count


def enabled() -> bool:
    """MXTPU_TELEMETRY gate (default on); 0/false/off makes every hook in
    this module a no-op."""
    return os.environ.get("MXTPU_TELEMETRY", "1").lower() \
        not in ("0", "false", "off", "")


class Counter:
    """Monotonic counter (batches, accumulated wait time)."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        with _LOCK:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth)."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = None

    def set(self, v):
        self.value = v


class MetricsRegistry:
    """Process-wide named-metric store: ``counter``/``gauge`` create or
    return; ``snapshot()`` is the read surface."""

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

    def snapshot(self) -> dict:
        return {name: m.value for name, m in list(self._metrics.items())}

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


def _emit(rec):
    """Append one record to the ring and, with ``MXTPU_TELEMETRY_PATH``
    set, to that JSONL file as one line."""
    with _LOCK:
        _RECENT.append(rec)
        del _RECENT[:-_RECENT_MAX]
    path = os.environ.get("MXTPU_TELEMETRY_PATH")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def event(kind, /, **fields):
    """Emit one discrete, run-id-stamped event record (a worker timeout,
    a quarantined batch, a serving reload).  The event name is
    positional-only so a detail field may itself be named ``kind``."""
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
    """Emit one per-request serving record: queue wait, prefill latency,
    per-token decode latency, the (batch, seq) bucket the request was
    padded into and the padding it paid; ``fields`` add the trace
    (``trace_id``, ``spans``), ``replica_id``, ``deadline_exceeded``."""
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


def _read_jsonl(path):
    """The records of a JSONL log, skipping a torn (unparseable) line."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except FileNotFoundError:
        pass
    return out


def recent_requests(jsonl=None):
    """Per-request serving records, oldest first, of the last
    ``_RECENT_MAX`` records: the in-memory ring, or (with ``jsonl=``) a
    JSONL log's."""
    if jsonl is not None:
        recs = _read_jsonl(jsonl)[-_RECENT_MAX:]
    else:
        with _LOCK:
            recs = list(_RECENT)
    return [r for r in recs if r.get("type") == "request"]


def event_counts() -> dict:
    with _LOCK:
        return dict(_EVENT_COUNTS)


def reset():
    """Drop the ring, the event counts and the registry (test isolation,
    not a runtime API)."""
    with _LOCK:
        _RECENT.clear()
        _EVENT_COUNTS.clear()
    REGISTRY.reset()


# -- schema validation ---------------------------------------------------------

def _validate_spans(spans, fail):
    """A request's ``spans`` field must be one closed causal tree: every
    span has an id, name, t0 and dur_us, exactly one root (parent null),
    and every parent id resolves inside the list."""
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
    """Raise ValueError unless ``rec`` is a well-formed ``event`` or
    ``request`` record of this schema; returns ``rec``."""

    def fail(msg):
        raise ValueError(f"telemetry record invalid: {msg}; record={rec!r}")

    if not isinstance(rec, dict):
        fail("not an object")
    kind = rec.get("type")
    if kind not in ("event", "request"):
        fail(f"type must be 'event'|'request', got {kind!r}")
    if not isinstance(rec.get("run"), str) or not rec["run"]:
        fail("missing run id")
    if not isinstance(rec.get("t"), (int, float)):
        fail("missing timestamp t")
    if rec.get("v") not in _ACCEPTED_VERSIONS:
        fail(f"schema version {rec.get('v')!r} not in "
             f"{_ACCEPTED_VERSIONS}")
    rid = rec.get("replica_id")
    if rid is not None and (not isinstance(rid, int) or
                            isinstance(rid, bool) or rid < 0):
        fail("replica_id must be an int >= 0 or absent")
    if kind == "event":
        if not isinstance(rec.get("event"), str) or not rec["event"]:
            fail("event record missing event kind")
        return rec
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
        if val is not None and (not isinstance(val, int) or val < 0):
            fail(f"{key} must be a non-negative int or absent")
    de = rec.get("deadline_exceeded")
    if de is not None and not isinstance(de, bool):
        fail("deadline_exceeded must be a bool or absent")
    return rec
