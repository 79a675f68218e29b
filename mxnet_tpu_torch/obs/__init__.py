"""Fleet observability: request spans, the host collector and the
metrics exporter.

Counterpart of ``mxnet_tpu/obs/``, on top of ``telemetry`` and the gang
KV (``distributed.gang_kv()``):

- ``obs.spans``: one causal span tree a served request, carried in the
  request's telemetry record;
- ``obs.collector``: ``HostCollector`` tails this host's telemetry JSONL
  from a daemon thread and folds it into bounded rollups published at
  ``obs/rollup/<rank>``; ``FleetView`` aggregates them (fleet MFU, skew,
  stragglers, the event timeline); a ``profile/req`` key asks for a
  bounded ``torch.profiler`` trace;
- ``obs.exporter``: a Prometheus text endpoint over the metrics registry
  and the fleet rollup (``MXTPU_METRICS_PORT``).

``ensure_from_env()`` is the once-per-process bootstrap the Trainer
calls; it does nothing unless ``MXTPU_METRICS_PORT`` or
``MXTPU_OBS_COLLECTOR`` asks for it.
"""

from __future__ import annotations

import os
import threading

from .spans import Span, Trace, new_id, render_tree

__all__ = [
    "Span", "Trace", "new_id", "render_tree",
    "HostCollector", "FleetView", "MetricsExporter",
    "ensure_from_env", "shutdown",
]

_LOCK = threading.Lock()
_STARTED = False
_COLLECTOR = None
_EXPORTER = None


def __getattr__(name):
    # lazy submodule attributes: keep `import mxnet_tpu.obs` free of
    # http.server / distributed imports until actually used
    if name in ("HostCollector", "FleetView"):
        from . import collector

        return getattr(collector, name)
    if name in ("MetricsExporter", "render_prometheus"):
        from . import exporter

        return getattr(exporter, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def ensure_from_env():
    """Start the exporter and/or collector once per process when the
    env opts in; safe to call from every Trainer construction.

    - ``MXTPU_METRICS_PORT`` set → MetricsExporter on that port (0 =
      ephemeral), with a FleetView attached when a gang KV exists.
    - ``MXTPU_OBS_COLLECTOR=1`` (or a metrics port + a telemetry path)
      → HostCollector publishing rollups every MXTPU_OBS_ROLLUP_SECS.

    Returns (collector, exporter) — either may be None."""
    global _STARTED, _COLLECTOR, _EXPORTER
    with _LOCK:
        if _STARTED:
            return _COLLECTOR, _EXPORTER
        _STARTED = True
        port_raw = os.environ.get("MXTPU_METRICS_PORT")
        want_collector = os.environ.get(
            "MXTPU_OBS_COLLECTOR", "").lower() in ("1", "true", "on")
        from .. import telemetry

        if port_raw is None and not want_collector:
            return None, None
        kv = None
        try:
            from .. import distributed

            kv = distributed.gang_kv()
        except Exception:
            kv = None
        if (want_collector or port_raw is not None) \
                and telemetry.telemetry_path():
            try:
                from .collector import HostCollector

                _COLLECTOR = HostCollector(kv=kv).start()
            except Exception:
                _COLLECTOR = None
        if port_raw is not None:
            try:
                from .collector import FleetView
                from .exporter import MetricsExporter

                fleet = FleetView(kv) if kv is not None else None
                _EXPORTER = MetricsExporter(port=int(port_raw),
                                            fleet=fleet)
            except Exception:
                _EXPORTER = None
        return _COLLECTOR, _EXPORTER


def shutdown():
    """Stop whatever ensure_from_env started (test isolation)."""
    global _STARTED, _COLLECTOR, _EXPORTER
    with _LOCK:
        if _COLLECTOR is not None:
            _COLLECTOR.close()
        if _EXPORTER is not None:
            _EXPORTER.close()
        _COLLECTOR = _EXPORTER = None
        _STARTED = False
