"""Request spans: one causal tree per served request.

Counterpart of ``mxnet_tpu/obs/spans.py``, copied whole (it is plain
Python: no array library).  A request entering the batcher mints a
:class:`Trace` (or arrives with one minted upstream); the trace rides the
submit -> batcher -> engine call chain, collecting host-side spans (queue,
prefill, decode) with wall-clock t0s and microsecond durations.  The closed
tree is embedded in the request's telemetry record (``trace_id`` and
``spans`` fields), so a request's latency waterfall costs no device work
and no extra record.

Span semantics (checked by ``telemetry.validate_record``):

- exactly one root span (``parent: null``) per trace;
- every span is closed (``dur_us`` >= 0) before the record is emitted;
- ``t0`` is epoch seconds (host wall clock), so spans from different
  processes order on one timeline;
- ``attrs`` carry per-span context (replica id, bucket, generation) as
  flat JSON scalars.

Thread-safety: a trace is built by the submitting thread and closed by the
batcher thread; mutation is append/assign under the trace's lock.
"""

from __future__ import annotations

import os
import threading
import time


def new_id() -> str:
    """64-bit random hex id (span and trace ids)."""
    return os.urandom(8).hex()


class Span:
    """One named interval.  ``dur_us`` is None while open."""

    __slots__ = ("span_id", "parent", "name", "t0", "dur_us", "attrs",
                 "_t0_perf")

    def __init__(self, name, parent=None, t0=None):
        self.span_id = new_id()
        self.parent = parent          # parent span_id or None (root)
        self.name = str(name)
        self.t0 = float(t0) if t0 is not None else time.time()
        self.dur_us = None
        self.attrs = {}
        self._t0_perf = time.perf_counter()

    def close(self, dur_us=None, t_end=None):
        """Close the span: explicit duration, explicit end time, or
        elapsed-since-open (monotonic clock)."""
        if dur_us is not None:
            self.dur_us = max(float(dur_us), 0.0)
        elif t_end is not None:
            self.dur_us = max((float(t_end) - self.t0) * 1e6, 0.0)
        else:
            self.dur_us = max(
                (time.perf_counter() - self._t0_perf) * 1e6, 0.0)
        return self

    def to_dict(self) -> dict:
        d = {"span_id": self.span_id, "parent": self.parent,
             "name": self.name, "t0": self.t0,
             "dur_us": round(self.dur_us, 1)
             if self.dur_us is not None else None}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Trace:
    """A request's span tree, carried through the serving call chain."""

    def __init__(self, trace_id=None):
        self.trace_id = trace_id or new_id()
        self._spans = []
        self._lock = threading.Lock()

    def begin(self, name, parent=None, t0=None, **attrs) -> Span:
        """Open a span.  `parent` is a Span (or a span_id string);
        None makes it the root."""
        pid = parent.span_id if isinstance(parent, Span) else parent
        sp = Span(name, parent=pid, t0=t0)
        if attrs:
            sp.attrs.update({k: v for k, v in attrs.items()
                             if v is not None})
        with self._lock:
            self._spans.append(sp)
        return sp

    def spans(self):
        with self._lock:
            return list(self._spans)

    def root(self):
        """The root span (parent None), or None before one is begun."""
        with self._lock:
            for sp in self._spans:
                if sp.parent is None:
                    return sp
        return None

    def close_open(self, t_end=None):
        """Close every still-open span (the batcher calls this at
        request completion so upstream spans — the FrontDoor root —
        end with the request)."""
        for sp in self.spans():
            if sp.dur_us is None:
                sp.close(t_end=t_end)
        return self

    def closed(self) -> bool:
        """True when the tree is emittable: non-empty, every span
        closed, exactly one root."""
        spans = self.spans()
        return bool(spans) and \
            all(sp.dur_us is not None for sp in spans) and \
            sum(1 for sp in spans if sp.parent is None) == 1

    def to_fields(self) -> dict:
        """The record fields the batcher passes into
        `telemetry.request_record` — drops any still-open span rather
        than emit an invalid tree."""
        spans = [sp.to_dict() for sp in self.spans()
                 if sp.dur_us is not None]
        return {"trace_id": self.trace_id, "spans": spans}


def render_tree(spans, indent="  ") -> list:
    """ASCII-render a span dict list (as stored in a request record)
    into lines: children nested under parents, durations aligned.
    Kept beside the spans so tests exercise the renderer a report
    tool ships."""
    by_parent = {}
    by_id = {}
    for sp in spans:
        by_id[sp["span_id"]] = sp
        by_parent.setdefault(sp.get("parent"), []).append(sp)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s.get("t0", 0.0))
    lines = []

    def walk(sp, depth):
        attrs = sp.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        dur = sp.get("dur_us")
        dur_txt = f"{dur / 1000.0:8.2f} ms" if dur is not None \
            else "    open  "
        lines.append(f"{indent * depth}{sp['name']:<12} {dur_txt}"
                     f"{('  ' + extra) if extra else ''}")
        for kid in by_parent.get(sp["span_id"], []):
            walk(kid, depth + 1)

    for root in by_parent.get(None, []):
        walk(root, 0)
    # orphans (parent id not in the record) still render, flagged
    known = set(by_id)
    for sp in spans:
        p = sp.get("parent")
        if p is not None and p not in known:
            lines.append(f"?? orphan {sp['name']} (parent {p})")
    return lines
