"""Generated symbol op wrappers.

Counterpart of ``mxnet_tpu/symbol/register.py`` (reference:
python/mxnet/symbol/register.py): every op of the port's registry gets a
wrapper under its name in ``mx.sym``, making a graph node instead of
running the op.
"""

from __future__ import annotations

from ..ops import registry as _registry
from .symbol import Symbol, apply_op


def _make_wrapper(opname):
    def wrapper(*args, name=None, **kwargs):
        if args and not any(isinstance(a, Symbol) for a in args) and \
                not any(isinstance(v, Symbol) for v in kwargs.values()):
            raise TypeError(f"symbol op {opname} expects Symbol inputs; "
                            f"for arrays use mx.nd.{opname}")
        return apply_op(opname, *args, name=name, **kwargs)

    wrapper.__name__ = opname
    wrapper.__qualname__ = opname
    wrapper.__doc__ = f"(symbol wrapper for op '{opname}')"
    return wrapper


def populate(namespace):
    for opname in _registry.all_ops():
        if opname not in namespace:
            namespace[opname] = _make_wrapper(opname)
