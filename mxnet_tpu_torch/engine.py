"""Execution-engine policy.

Counterpart of ``mxnet_tpu/engine.py:1-33,88-135``.  CUDA work is already
asynchronous and ordered on its stream, so what remains is the policy the
reference exposes:

- ``MXNET_ENGINE_TYPE=NaiveEngine``: every op synchronises after it runs
  (bisecting asynchronous faults, reference: src/engine/naive_engine.cc);
- ``wait_all()``: drain every card (reference: Engine::WaitForAll); a
  device fault surfaces here or at an array's ``wait_to_read``.

The JAX package's persistent compile cache (``ensure_compile_cache``) has
no counterpart: nothing here is compiled ahead of a call.  ``bulk`` and
``set_bulk_size`` keep the reference's API and its nominal window of 15;
ops launch one by one, so the window tunes nothing.
"""

from __future__ import annotations

import contextlib
import os

import torch

_NAIVE = os.environ.get("MXNET_ENGINE_TYPE", "").lower() == "naiveengine"


def is_naive() -> bool:
    """Whether the NaiveEngine (every op synchronous) is selected."""
    return _NAIVE


def set_engine_type(name: str) -> None:
    """'NaiveEngine' makes every op synchronous; anything else async."""
    global _NAIVE
    _NAIVE = name.lower() == "naiveengine"


def maybe_sync(t):
    """Synchronise on a CUDA tensor's device under NaiveEngine; returns
    the tensor."""
    if _NAIVE and isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def wait_all() -> None:
    """Block until every card's queued work has completed."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


_BULK_SIZE = 15  # the reference's default op-bulking window


def bulk(size: int | None = None):
    """``mx.engine.bulk``: a context manager for API compatibility; it
    changes nothing (each op launches as it is called)."""
    return contextlib.nullcontext()


def set_bulk_size(size):
    """``mx.engine.set_bulk_size``: record the nominal op-bulking window
    and return the previous one."""
    global _BULK_SIZE
    prev = _BULK_SIZE
    _BULK_SIZE = int(size)
    return prev
