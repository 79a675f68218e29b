"""mx.nd: the imperative NDArray API.

Counterpart of ``mxnet_tpu/ndarray/__init__.py:24-145``: the namespace
carries the NDArray class, the creation functions, ``save``/``load`` and
every registered op as a generated wrapper.  Arrays are created on
``ctx``, default ``current_context()``: ``gpu(0)`` unless a ``with
mx.cpu():`` scope is open.  ``sparse`` holds the compact storage types
(``ndarray/sparse.py``), ``linalg`` the linear-algebra ops and
``contrib`` the control flow (``foreach``, ``while_loop`` and ``cond``,
also at the top level, as in the JAX package) and the contrib ops.
"""

from __future__ import annotations

import numpy as _np
import torch

from .. import ops as _ops  # noqa: F401  (registers the op families)
from ..base import MXNetError, torch_dtype  # noqa: F401  (mx.nd.MXNetError)
from ..context import Context, current_context  # noqa: F401
from .ndarray import NDArray
from . import register as _register
from .utils import save, load


def _device(ctx):
    ctx = ctx or current_context()
    return ctx.device, ctx


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array``; float32 unless
    ``dtype`` is given (bool sources stay bool)."""
    if isinstance(source_array, NDArray):
        out = source_array.astype(dtype) if dtype else source_array.copy()
        return out.as_in_context(ctx) if ctx else out
    dev, ctx = _device(ctx)
    np_arr = _np.asarray(source_array,
                         dtype=None if dtype in ("bfloat16", None) else dtype)
    if dtype is None and np_arr.dtype != _np.bool_:
        # reference semantics: default dtype is float32 for any non-NDArray
        # source (python/mxnet/ndarray/ndarray.py `array`)
        np_arr = np_arr.astype(_np.float32)
    t = torch.tensor(np_arr, device=dev)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return NDArray(t, ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    dev, ctx = _device(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    dev, ctx = _device(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=dev), ctx)


def full(shape, val, ctx=None, dtype=None):
    dev, ctx = _device(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=dev), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    dev, ctx = _device(ctx)
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=dev)
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray(out, ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    dev, ctx = _device(ctx)
    dt = torch_dtype(dtype)
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=dt, device=dev)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=dt,
                             device=dev)[:num].clone()
    return NDArray(out, ctx)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    dev, ctx = _device(ctx)
    M = M or N
    hit = (torch.arange(M, device=dev)[None, :]
           - torch.arange(N, device=dev)[:, None]) == k
    return NDArray(hit.to(torch_dtype(dtype)), ctx)


def from_numpy(a, zero_copy=False):
    """An NDArray holding ``a``, as ``array(a)`` makes it (float32 unless
    ``a`` is bool).  ``zero_copy`` is accepted for API parity: the array
    is always a copy, since a card cannot share the host's buffer."""
    return array(a)


def from_dlpack(capsule):
    """An NDArray over a DLPack capsule's (or a ``__dlpack__`` object's)
    memory, through ``torch.utils.dlpack``: no copy, on the producer's
    device."""
    from ..context import context_of

    t = torch.utils.dlpack.from_dlpack(capsule)
    return NDArray(t, context_of(t.device))


def concatenate(arrays, axis=0, always_copy=True):
    return _register.invoke_registered("concat", tuple(arrays),
                                       {"dim": axis})


def waitall():
    from .. import engine

    engine.wait_all()


def moveaxis(a, source, destination):
    return a._apply(lambda d: torch.movedim(d, source, destination),
                    name="moveaxis")


# control-flow higher-order ops (the reference keeps them under contrib)
from ..ops.control_flow import cond, foreach, while_loop  # noqa: E402,F401

# generated op wrappers -> module namespace
_register.populate(globals())

# sub-namespaces
from . import random  # noqa: E402
from . import sparse  # noqa: E402
from . import linalg  # noqa: E402
from . import contrib  # noqa: E402
