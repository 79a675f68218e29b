"""Telemetry: the counters, gauges and events the input path reports.

Counterpart of the parts of ``mxnet_tpu/telemetry.py`` that the input
path calls (``enabled``, ``count``, ``gauge_set``, ``event``,
``event_counts``; ``telemetry.py:147, 264-275, 607-660``): a process-wide
registry of named counters and gauges, and discrete run-stamped event
records, counted by kind and, with ``MXTPU_TELEMETRY_PATH`` set, appended
to that JSONL file one line a record.  ``MXTPU_TELEMETRY=0`` makes every hook a no-op.  No hook touches
the device.

The rest of the module (the per-step ``StepStats`` records, MFU, the
sink's rotation, fleet identity) comes with the production planes,
ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import json
import os
import threading
import time

_LOCK = threading.Lock()

SCHEMA_VERSION = 1

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


def event(kind, /, **fields):
    """Emit one discrete, run-id-stamped event record (a worker timeout,
    a quarantined batch, a resumed pipeline).  The event name is
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
    path = os.environ.get("MXTPU_TELEMETRY_PATH")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def event_counts() -> dict:
    with _LOCK:
        return dict(_EVENT_COUNTS)


def reset():
    """Drop the event counts and the registry (test isolation, not a
    runtime API)."""
    with _LOCK:
        _EVENT_COUNTS.clear()
    REGISTRY.reset()
