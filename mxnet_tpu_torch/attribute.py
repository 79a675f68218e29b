"""Attribute scoping for symbol construction: ``mx.AttrScope``.

Counterpart of ``mxnet_tpu/attribute.py:17-55`` (reference:
python/mxnet/attribute.py).  ``with mx.AttrScope(ctx_group='stage1',
lr_mult='0.1'):`` attaches the given attributes to every Symbol node
made inside the scope: they land in the node's attribute dict
(``Symbol.attr``, ``Symbol.attr_dict``), serialise into ``-symbol.json``
and reach the optimizer's per-variable multipliers through ``Module``.
The scope stack is thread-local.
"""

from __future__ import annotations

import threading


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []


_LOCAL = _Local()


class AttrScope:
    """Attributes applied to the symbols made within (nestable; an inner
    scope overrides an outer one's keys).  Values must be strings, as the
    reference requires: they serialise into ``-symbol.json`` verbatim."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if v is not None and not isinstance(v, str):
                raise ValueError(
                    f"AttrScope: attribute {k}={v!r} must be a string "
                    f"(got {type(v).__name__})")
        self._attr = {k: v for k, v in kwargs.items() if v is not None}

    def __enter__(self):
        merged = dict(current_attrs())
        merged.update(self._attr)
        _LOCAL.stack.append(merged)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        _LOCAL.stack.pop()
        return False


def current_attrs():
    """The attributes of the innermost open scope ({} outside any)."""
    return _LOCAL.stack[-1] if _LOCAL.stack else {}
