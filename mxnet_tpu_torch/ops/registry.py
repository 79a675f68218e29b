"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py:28-79`` (the nnvm Op registry
and python/mxnet/ndarray/register.py's import-time wrapper generation).
An op is a pure function on ``torch.Tensor``s plus frontend metadata;
gradients come from ``torch.autograd``.  Every registered op gets a
generated NDArray-aware wrapper (``mxnet_tpu_torch.ndarray.register``):
called with NDArrays it runs the eager path (unwrap, compute, wrap,
recorded by torch's autograd while ``autograd.record()`` is open); called
with raw tensors it passes straight through to the pure function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..base import MXNetError


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable
    aliases: tuple = ()
    # Ops whose semantics depend on train vs predict mode (Dropout,
    # BatchNorm): the wrapper injects _is_training from the autograd scope.
    mode_dependent: bool = False
    # Ops that consume randomness: the wrapper injects a torch.Generator
    # kwarg (named _key) from the package's generator chain when unset.
    random: bool = False
    # Opaque ops run on NDArrays directly (host-level, own tape handling);
    # the invoke layer must not unwrap them.
    opaque: bool = False


_OPS: dict[str, OpDef] = {}


def register(name: str | None = None, aliases: tuple = (),
             mode_dependent: bool = False, random: bool = False,
             opaque: bool = False):
    """Decorator registering a pure tensor op under its reference name."""

    def _do(fn):
        opname = name or fn.__name__
        opdef = OpDef(opname, fn, tuple(aliases), mode_dependent, random,
                      opaque)
        if opname in _OPS:
            raise MXNetError(f"op {opname!r} registered twice")
        _OPS[opname] = opdef
        for a in opdef.aliases:
            _OPS.setdefault(a, OpDef(a, fn, (), mode_dependent, random,
                                     opaque))
        return fn

    return _do


def get(name: str) -> OpDef:
    if name not in _OPS:
        raise MXNetError(f"op {name!r} not registered")
    return _OPS[name]


def list_ops() -> list[str]:
    """All registered op names (reference: MXListAllOpNames)."""
    return sorted(_OPS)


def all_ops() -> dict[str, OpDef]:
    return dict(_OPS)
