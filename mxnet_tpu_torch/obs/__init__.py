"""Observability: request spans (``obs.spans``).

Counterpart of ``mxnet_tpu/obs/``'s span module; the host collector and
the metrics exporter belong to the production planes, not ported yet."""

from .spans import Span, Trace, new_id, render_tree

__all__ = ["Span", "Trace", "new_id", "render_tree"]
