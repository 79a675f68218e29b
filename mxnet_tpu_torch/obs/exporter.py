"""Live metrics export: a standard-library Prometheus text endpoint.

Counterpart of ``mxnet_tpu/obs/exporter.py``: an HTTP face on
``telemetry.REGISTRY.snapshot()`` (plus the fleet rollup when a
``FleetView`` is attached), with no dependency past ``http.server``.

- ``GET /metrics`` answers in the Prometheus text format (0.0.4):
  counters as ``counter``, gauges as ``gauge``, histograms as
  ``_count`` / ``_sum`` / ``_min`` / ``_max`` series, and the fleet's
  per-rank series labelled ``{rank="N"}``;
- names map ``.`` and ``-`` to ``_`` under an ``mxtpu_`` prefix
  (``collective.bytes`` is ``mxtpu_collective_bytes``);
- the server is a daemon ``ThreadingHTTPServer`` on
  ``MXTPU_METRICS_PORT`` (0 picks a free port); a scrape never touches
  the train thread.
"""

from __future__ import annotations

import os
import re
import threading

from .. import telemetry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    clean = _NAME_RE.sub("_", str(name))
    if not clean.startswith("mxtpu_"):
        clean = "mxtpu_" + clean
    return clean


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


def render_prometheus(snapshot, fleet_summary=None, registry=None) -> str:
    """Render a `MetricsRegistry.snapshot()` dict (+ optional
    `FleetView.summary()`) as Prometheus text exposition format."""
    lines = []
    reg = registry._metrics if registry is not None else {}

    for name in sorted(snapshot):
        val = snapshot[name]
        mname = _metric_name(name)
        if isinstance(val, dict):           # histogram summary
            lines.append(f"# TYPE {mname}_count counter")
            lines.append(f"{mname}_count {_fmt(val.get('count', 0))}")
            lines.append(f"# TYPE {mname}_sum counter")
            lines.append(f"{mname}_sum {_fmt(val.get('total', 0.0))}")
            for k in ("min", "max"):
                if isinstance(val.get(k), (int, float)):
                    lines.append(f"# TYPE {mname}_{k} gauge")
                    lines.append(f"{mname}_{k} {_fmt(val[k])}")
            continue
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        kind = "counter" if isinstance(reg.get(name),
                                       telemetry.Counter) else "gauge"
        lines.append(f"# TYPE {mname} {kind}")
        lines.append(f"{mname} {_fmt(val)}")

    if fleet_summary:
        fs = fleet_summary
        if fs.get("fleet_mfu") is not None:
            lines.append("# HELP mxtpu_fleet_mfu "
                         "step-weighted fleet MFU across ranks")
            lines.append("# TYPE mxtpu_fleet_mfu gauge")
            lines.append(f"mxtpu_fleet_mfu {_fmt(fs['fleet_mfu'])}")
        lines.append("# TYPE mxtpu_fleet_steps_total counter")
        lines.append(f"mxtpu_fleet_steps_total "
                     f"{_fmt(fs.get('steps_total', 0))}")
        lines.append("# TYPE mxtpu_fleet_ranks gauge")
        lines.append(f"mxtpu_fleet_ranks {_fmt(len(fs.get('ranks', [])))}")
        if fs.get("interval_skew") is not None:
            lines.append("# TYPE mxtpu_fleet_interval_skew gauge")
            lines.append(f"mxtpu_fleet_interval_skew "
                         f"{_fmt(fs['interval_skew'])}")
        for r, v in sorted((fs.get("interval_us") or {}).items()):
            lines.append('mxtpu_fleet_rank_interval_us'
                         f'{{rank="{r}"}} {_fmt(v)}')
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """The /metrics HTTP endpoint.  ``port=0`` binds an ephemeral port
    (read it back via ``.port``); ``fleet`` is an optional FleetView
    refreshed per scrape (scrape-rate bounded, not train-loop
    bounded)."""

    def __init__(self, port=None, host="127.0.0.1", registry=None,
                 fleet=None):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        if port is None:
            port = int(os.environ.get("MXTPU_METRICS_PORT", 0))
        self.registry = registry if registry is not None \
            else telemetry.REGISTRY
        self.fleet = fleet
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # no stderr spam per scrape
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="mxtpu-metrics-exporter", daemon=True)
        self._thread.start()

    def render(self) -> str:
        fleet_summary = None
        if self.fleet is not None:
            try:
                self.fleet.refresh()
                fleet_summary = self.fleet.summary()
            except Exception:
                fleet_summary = None
        return render_prometheus(self.registry.snapshot(),
                                 fleet_summary, registry=self.registry)

    def close(self):
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)
