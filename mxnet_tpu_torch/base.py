"""Base error type and dtype plumbing.

Counterpart of ``mxnet_tpu/base.py``; the port keeps its own copy of what
it needs from there (the error class, ``getenv_int`` and the dtype map)
and imports nothing of the JAX package.  The JAX package switches jax's x64 mode on
for explicit 64-bit dtypes; torch has native int64 and float64, so here a
dtype is simply mapped, and the results (explicit 64-bit types survive,
the default is float32) are the same.
"""

from __future__ import annotations

import os

import numpy as _np
import torch


class MXNetError(RuntimeError):
    """Framework error type (reference: MXGetLastError / dmlc::Error)."""


def getenv_int(name: str, default: int) -> int:
    """An integer from the environment, ``default`` when unset or not an
    integer (reference: dmlc::GetEnv, docs/faq/env_var.md)."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_NUMPY_TYPES = {v: _np.dtype(k).type for k, v in _TORCH_DTYPES.items()
                if k != "bfloat16"}


def torch_dtype(dtype) -> torch.dtype:
    """Normalise a dtype spec (None, a name, a numpy dtype or type, a torch
    dtype) to a torch dtype; None is float32, as ``np_dtype`` in the JAX
    package."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _TORCH_DTYPES[name]


def np_dtype(dtype):
    """The numpy scalar type of a dtype spec (``np.float32`` ...), as the
    JAX package's ``NDArray.dtype`` reports it; bfloat16, which numpy
    lacks, stays ``torch.bfloat16``."""
    t = torch_dtype(dtype)
    return _NUMPY_TYPES.get(t, t)
