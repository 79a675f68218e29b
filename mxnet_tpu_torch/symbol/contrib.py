"""``mx.sym.contrib``: wrappers for the contrib ops.

Counterpart of ``mxnet_tpu/symbol/contrib.py`` (reference:
python/mxnet/symbol/contrib.py): every registered ``_contrib_*`` or
``contrib_*`` op gets a wrapper under its short name.
"""

from __future__ import annotations

from ..ops import registry as _registry
from .symbol import apply_op


def _make_wrapper(opname):
    def wrapper(*args, name=None, **kwargs):
        return apply_op(opname, *args, name=name, **kwargs)

    wrapper.__name__ = opname
    wrapper.__doc__ = f"(symbol contrib wrapper for op '{opname}')"
    return wrapper


def _expose(ns):
    for name in _registry.all_ops():
        if name.startswith("_contrib_"):
            ns.setdefault(name[len("_contrib_"):], _make_wrapper(name))
        elif name.startswith("contrib_"):
            ns.setdefault(name[len("contrib_"):], _make_wrapper(name))


_expose(globals())
