"""Device contexts: ``Context``, ``cpu()``, ``gpu(i)``, ``current_context()``.

Counterpart of ``mxnet_tpu/context.py``.  A ``Context`` is a ``with``
scope and names a ``torch.device`` (``Context.device``); it compares equal
to that device, so code that passes ``cpu()`` where a ``torch.device`` is
expected keeps working.  Unlike the JAX package, whose ``gpu(i)`` silently
resolves to the CPU when no accelerator is present, ``gpu(i)`` here
raises: a run that asked for the card never lands on the CPU unnoticed.
With no scope open, ``current_context()`` is ``gpu(0)`` (the JAX
package's default is ``cpu(0)``): entry points run on the card unless the
caller opens ``with cpu():`` or passes ``cpu()``, as the tests do.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class _Stack(threading.local):
    def __init__(self):
        self.stack = []


class Context:
    """A device context; ``device_type`` is ``cpu`` or ``gpu``
    (``cpu_pinned`` is accepted and means ``cpu``)."""

    _stack = _Stack()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in ("cpu", "gpu", "cpu_pinned"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = "cpu" if device_type == "cpu_pinned" \
            else device_type
        self.device_id = int(device_id)
        if self.device_type == "gpu":
            n = num_gpus()
            if self.device_id < 0 or self.device_id >= n:
                raise MXNetError(
                    f"gpu({self.device_id}): no such CUDA device ({n} "
                    f"visible); pass device=cpu() to run on the host")

    @property
    def device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_type, self.device_id) == (
                other.device_type, other.device_id)
        if isinstance(other, torch.device):
            return self.device == other
        return NotImplemented

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        Context._stack.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._stack.stack.pop()

    @classmethod
    def default_ctx(cls):
        return scoped_context() or gpu(0)


def cpu(device_id: int = 0) -> Context:
    """The host.  ``device_id`` is kept for API parity; PyTorch has one
    CPU device."""
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA card ``device_id``; raises MXNetError when it is absent."""
    return Context("gpu", device_id)


def scoped_context():
    """The innermost ``with ctx:`` scope, or None when none is open."""
    stack = Context._stack.stack
    return stack[-1] if stack else None


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    return Context.default_ctx()


def context_of(device: torch.device) -> Context:
    """The Context naming a tensor's device."""
    if device.type == "cuda":
        return gpu(0 if device.index is None else device.index)
    return cpu()


def resolve(device) -> torch.device:
    """An entry point's ``device`` argument (a Context, a torch.device, a
    string or None) as a torch.device; None means ``current_context()``."""
    if device is None:
        return current_context().device
    if isinstance(device, Context):
        return device.device
    device = torch.device(device)
    if device.type == "cuda":
        return gpu(0 if device.index is None else device.index).device
    return device
