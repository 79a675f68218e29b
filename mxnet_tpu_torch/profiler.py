"""Profiler.

Counterpart of ``mxnet_tpu/profiler.py`` (reference: src/profiler/ +
python/mxnet/profiler.py): ``set_config`` / ``set_state('run'|'stop')`` /
``pause`` / ``resume`` / ``dump`` / aggregate stats, chrome://tracing JSON
output, and ``MXNET_PROFILER_AUTOSTART``.

The host tracer records named spans (``record_span``, ``op_span``,
``annotate``); device time belongs to ``torch.profiler``:
``start_xla_trace`` / ``stop_xla_trace`` keep the JAX package's names and
run a ``torch.profiler`` trace of the CPU and the card, written as a
chrome trace into ``log_dir``.  ``annotate(name)`` is the named phase
marker of the hot paths (``h2d_prefetch``, ``optimizer_update`` ...):
while a ``torch.profiler`` trace or the host profiler is running it opens
a ``torch.profiler.record_function`` (and an NVTX range on a CUDA build),
so the span shows named in the trace next to the device work it covers;
with both off it costs two ``perf_counter`` reads.  Every scope's host
duration goes to ``telemetry.on_scope``, which is how a step record gets
its breakdown without the profiler on.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict

import torch

from . import telemetry as _telemetry

_LOCK = threading.Lock()


class _State:
    running = False
    sync = False
    filename = "profile.json"
    events: list = []
    aggregate: dict = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    trace = None       # (torch.profiler.profile, log_dir) while open


_S = _State()


def is_running() -> bool:
    return _S.running


def set_config(profile_all=False, profile_symbolic=False,
               profile_imperative=False, profile_memory=False,
               profile_api=False, filename="profile.json",
               continuous_dump=False, profile_sync=False, **kwargs):
    """Reference: mx.profiler.set_config (MXSetProcessProfilerConfig)."""
    _S.filename = filename
    _S.sync = profile_sync


def set_state(state="stop", profile_process="worker"):
    """'run' starts collection; 'stop' ends it (reference:
    MXSetProcessProfilerState)."""
    if state == "run":
        _S.running = True
    elif state == "stop":
        _S.running = False
    else:
        raise ValueError("state must be 'run' or 'stop'")


def pause(profile_process="worker"):
    _S.running = False


def resume(profile_process="worker"):
    _S.running = True


def record_span(name, category, t_start, t_end):
    """One host span (seconds on ``time.perf_counter``'s clock)."""
    with _LOCK:
        _S.events.append({
            "name": name, "cat": category, "ph": "X",
            "ts": t_start * 1e6, "dur": (t_end - t_start) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident()})
        agg = _S.aggregate[name]
        agg[0] += 1
        dur = (t_end - t_start) * 1e3
        agg[1] += dur
        agg[2] = min(agg[2], dur)
        agg[3] = max(agg[3], dur)


class _OpSpan:
    """Context manager used by an op dispatch layer."""

    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record_span(self.name, "operator", self.t0, time.perf_counter())


def op_span(name):
    return _OpSpan(name)


def want_sync() -> bool:
    return _S.running and _S.sync


def dumps(reset=False):
    """Chrome-trace JSON string (reference: MXDumpProfile)."""
    with _LOCK:
        out = json.dumps({"traceEvents": list(_S.events),
                          "displayTimeUnit": "ms"})
        if reset:
            _S.events.clear()
    return out


def dump(finished=True, profile_process="worker"):
    with open(_S.filename, "w") as f:
        f.write(dumps())


def get_summary(reset=False):
    """Aggregate per-span stats table (reference:
    MXAggregateProfileStatsPrint)."""
    with _LOCK:
        lines = [f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}"
                 f"{'Min(ms)':>10}{'Max(ms)':>10}{'Avg(ms)':>10}"]
        for name, (count, total, mn, mx) in sorted(
                _S.aggregate.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<40}{count:>8}{total:>12.3f}{mn:>10.3f}"
                         f"{mx:>10.3f}{total / count:>10.3f}")
        if reset:
            _S.aggregate.clear()
    return "\n".join(lines)


def aggregates(reset=False):
    """Structured counterpart of `get_summary`: ``{name: {count,
    total_ms, min_ms, max_ms}}``."""
    with _LOCK:
        out = {name: {"count": count, "total_ms": total,
                      "min_ms": mn, "max_ms": mx}
               for name, (count, total, mn, mx) in _S.aggregate.items()}
        if reset:
            _S.aggregate.clear()
    return out


dump_profile = dump
profiler_set_config = set_config
profiler_set_state = set_state


# -- device tracing (torch.profiler) -------------------------------------------

def start_xla_trace(log_dir="profile_trace"):
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the card; ``stop_xla_trace`` writes it as a chrome trace into
    ``log_dir`` (view in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, **all_threads())
    prof.__enter__()
    _S.trace = (prof, log_dir)
    return log_dir


def stop_xla_trace():
    """Stop the trace ``start_xla_trace`` opened; returns the path of the
    chrome trace it wrote."""
    prof, log_dir = _S.trace
    _S.trace = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def all_threads():
    """``torch.profiler.profile`` keyword arguments that make it record
    the spans of every thread (the prefetcher's producer thread among
    them), where this torch supports it; empty otherwise."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


_NVTX = None


def _nvtx():
    """``torch.cuda.nvtx`` on a CUDA build with a card, else None."""
    global _NVTX
    if _NVTX is None:
        _NVTX = torch.cuda.nvtx if torch.cuda.is_available() else False
    return _NVTX or None


def _traced() -> bool:
    """True while a trace can see a span: the host profiler running, or
    a ``torch.profiler`` (this module's or the caller's) recording."""
    return _S.running or torch.autograd.profiler._is_profiler_enabled


def annotate(name):
    """Named phase marker for hot-path stages ("h2d_prefetch",
    "optimizer_update" ...): a ``record_function`` and an NVTX range
    while a trace can see them, plus a host span while the host profiler
    runs."""
    return scope(name)


class scope:
    """Annotation scope appearing in both host and device traces."""

    __slots__ = ("name", "_rf", "_nv", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._rf = self._nv = None
        if _traced():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            self._nv = _nvtx()
            if self._nv is not None:
                self._nv.range_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._nv is not None:
            self._nv.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if _S.running:
            record_span(self.name, "scope", self._t0, t1)
        _telemetry.on_scope(self.name, t1 - self._t0)


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    set_state("run")
