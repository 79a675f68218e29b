"""``mx.nd.contrib``: the control-flow functions (``foreach``,
``while_loop``, ``cond``), ``div_sqrt_dim``, ``arange_like`` and every
registered ``_contrib_*``/``contrib_*`` op under its public name
(counterpart of ``mxnet_tpu/ndarray/contrib.py``)."""

from __future__ import annotations

from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401
from ..ops import registry as _registry
from . import register as _register


def _expose(namespace=None):
    ns = namespace if namespace is not None else globals()
    for name, opdef in _registry.all_ops().items():
        if name.startswith("_contrib_"):
            public = name[len("_contrib_"):]
        elif name.startswith("contrib_"):
            public = name[len("contrib_"):]
        else:
            continue
        ns.setdefault(public, _register._make_wrapper(opdef))


def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])``."""
    return data / (data.shape[-1] ** 0.5)


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``arange`` of ``data``'s size (or of its ``axis``), on its
    context."""
    from . import arange

    n = data.size if axis is None else data.shape[axis]
    return arange(start, start + step * n, step, repeat=repeat,
                  ctx=data.context)


_expose()
