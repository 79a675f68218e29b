"""Device-memory management surface.

Counterpart of ``mxnet_tpu/storage.py`` (reference: src/storage/
pooled_storage_manager.h and the ``MXNET_GPU_MEM_POOL_*`` knobs).  On the
card the allocator is PyTorch's caching allocator, so the JAX package's
knobs map onto it:

- ``MXNET_TPU_MEM_FRACTION`` -> ``torch.cuda.set_per_process_memory_fraction``
  on every visible card: the share of each card the process may use;
- ``MXNET_TPU_PREALLOCATE`` (``true``) -> that share (0.75 when no fraction
  is given, XLA's default) reserved into the allocator's cache at its
  first use and kept there, the pooled behaviour;
- ``MXNET_TPU_ALLOCATOR=platform`` -> ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``,
  one device allocation a tensor (the reference's Naive pool).

``apply_env()`` runs at package import.  It sets environment variables
only and queues the rest with ``torch.cuda``'s lazy initialisation, so
the knobs take effect when CUDA first starts, before the allocator's first
use, and importing the package never starts CUDA.  An explicit PyTorch
setting wins: ``PYTORCH_NO_CUDA_MEMORY_CACHING`` already set is kept.
"""

from __future__ import annotations

import os

_PREALLOCATE_DEFAULT_FRACTION = 0.75
_applied = {}


def settings():
    """What ``apply_env`` took from the environment: ``memory_fraction``
    (None when unset), ``preallocate`` and ``caching``."""
    return dict(_applied)


def _truthy(value):
    return value.strip().lower() in ("1", "true", "yes", "on")


def _on_cuda_init(fraction, preallocate):
    import torch

    for i in range(torch.cuda.device_count()):
        if fraction is not None:
            torch.cuda.set_per_process_memory_fraction(fraction, i)
        if preallocate:
            share = _PREALLOCATE_DEFAULT_FRACTION if fraction is None \
                else fraction
            _free, total = torch.cuda.mem_get_info(i)
            block = torch.empty(int(total * share * 0.95), dtype=torch.uint8,
                                device=torch.device("cuda", i))
            del block                 # freed into the cache, kept reserved


def apply_env():
    """Map the MXNET_TPU_* memory knobs onto the caching allocator."""
    fraction = os.environ.get("MXNET_TPU_MEM_FRACTION")
    fraction = float(fraction) if fraction else None
    preallocate = _truthy(os.environ.get("MXNET_TPU_PREALLOCATE", "false"))
    if os.environ.get("MXNET_TPU_ALLOCATOR", "").strip() == "platform":
        os.environ.setdefault("PYTORCH_NO_CUDA_MEMORY_CACHING", "1")
    caching = os.environ.get("PYTORCH_NO_CUDA_MEMORY_CACHING", "0") != "1"
    _applied.update(memory_fraction=fraction, preallocate=preallocate,
                    caching=caching)
    if fraction is not None or preallocate:
        import torch

        torch.cuda._lazy_call(lambda: _on_cuda_init(fraction, preallocate))


def _device(ctx):
    """The torch.device of a memory query, or None for the host."""
    import torch

    if ctx is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() else None
    device = getattr(ctx, "device", ctx)
    device = torch.device(device)
    return device if device.type == "cuda" else None


def memory_info(ctx=None):
    """(free_bytes, total_bytes) of a card (reference:
    mx.context.gpu_memory_info), from ``torch.cuda.mem_get_info``; (None,
    None) for the host.  ``ctx`` None is card 0 when there is one."""
    import torch

    dev = _device(ctx)
    if dev is None:
        return (None, None)
    free, total = torch.cuda.mem_get_info(dev)
    return (int(free), int(total))


def memory_summary(ctx=None):
    """Human-readable memory statistics (reference analog: the storage
    profiler dump)."""
    free, total = memory_info(ctx)
    if total is None:
        return "device exposes no memory statistics"
    used = total - free
    return (f"used {used / 2**20:.1f} MiB / {total / 2**20:.1f} MiB "
            f"({100.0 * used / total:.1f}%)")
