"""Automatic naming: ``NameManager`` and ``Prefix``.

Counterpart of ``mxnet_tpu/name.py`` (reference: python/mxnet/name.py).
The counters are per process, as there: the n-th top-level ``ResNetV1``
built is ``resnetv1{n}_``, so two processes (or the two packages in one
process) may number the same model differently; ``convert`` compares
names with the top-level prefix stripped.
"""

from __future__ import annotations

import threading


class NameManager:
    """Assigns unique names per hint from counters; a ``with`` scope."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}"

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Adds a prefix to every name (reference: mx.name.Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """The innermost manager of this thread (a process-wide one at
    first)."""
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
