"""Shared-memory DataLoader worker internals.

Counterpart of ``mxnet_tpu/gluon/data/_shm_worker.py``.  This module is
numpy and the standard library only: workers never touch torch or a
device at task time (collation is host work; device placement happens in
the parent), and NDArray samples are handled by duck-typing on
``asnumpy`` so nothing here depends on the rest of the package.

Transport layout: the parent allocates ``nslots`` fixed-size
``multiprocessing.RawArray`` slots (anonymous shared mmap — no names, no
``resource_tracker`` bookkeeping, freed with the last handle) and hands one
free slot id out with every task.  A worker collates the batch *directly
into* numpy views of its slot — the collation copy is the transport copy —
and sends only ``(offset, shape, dtype)`` metadata through the result
queue.  Batches that don't fit the slot (or aren't flat numpy) fall back to
pickling through the queue, which is always correct, merely slower.

``collate_column(column, out=)`` is also what ``DevicePrefetcher`` uses
to collate a batch once, straight into its pinned staging memory.
"""

from __future__ import annotations

import os as _os
import time as _time
import traceback

import numpy as _np

# slot offsets are aligned so every leaf view starts on a cache line
_ALIGN = 64


def _maybe_data_fault(batch_idx):
    """stdlib mirror of ``resilience.maybe_data_fault`` for spawn
    workers (this module must stay importable without the package):
    parses ``MXTPU_FAULT_INJECT`` directly for the two input-pipeline
    sites — ``worker_hang:K`` (the fetch of batch K sleeps
    ``MXTPU_DATA_HANG_SECS``, long past any receive timeout) and
    ``data_skew:K`` (fetches of the first K batches each sleep
    ``MXTPU_DATA_SKEW_SECS``)."""
    spec = _os.environ.get("MXTPU_FAULT_INJECT")
    if not spec:
        return
    for item in spec.split(","):
        site, _, arg = item.strip().partition(":")
        try:
            k = int(arg) if arg else 0
        except ValueError:
            continue
        if site == "worker_hang" and k == int(batch_idx):
            _time.sleep(float(_os.environ.get("MXTPU_DATA_HANG_SECS",
                                              10.0)))
        elif site == "data_skew" and int(batch_idx) < k:
            _time.sleep(float(_os.environ.get("MXTPU_DATA_SKEW_SECS",
                                              0.05)))


def _leaf_np(x):
    """One sample leaf -> numpy (duck-typed NDArray support)."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return _np.asarray(x)


def collate_column(column, out=None):
    """Collate one column of leaf samples into a single contiguous buffer.

    Single-copy: each sample is written once into the preallocated batch
    buffer.  Falls back to ``np.asarray`` (the legacy stacking path, with
    its promotion semantics) when samples disagree in shape or dtype.
    """
    arrs = [_leaf_np(a) for a in column]
    a0 = arrs[0]
    if any(a.shape != a0.shape or a.dtype != a0.dtype for a in arrs[1:]):
        return _np.asarray(arrs)
    if out is None:
        out = _np.empty((len(arrs),) + a0.shape, a0.dtype)
    for i, a in enumerate(arrs):
        out[i] = a
    return out


def collate_samples(samples):
    """Structure-preserving single-copy collation (the host half of
    ``default_batchify_fn``): tuple samples -> list of batch arrays."""
    first = samples[0]
    if isinstance(first, (list, tuple)):
        return [collate_samples(list(col)) for col in zip(*samples)]
    return collate_column(samples)


def _collate_into_slot(samples, buf):
    """Collate a batch of flat (non-nested) samples directly into `buf`.

    Returns ``(metas, is_list)`` with ``metas = [(offset, shape,
    dtype_str), ...]`` on success, or None when the batch needs the
    pickle fallback (nested samples, ragged shapes/dtypes, or the batch
    doesn't fit the slot).
    """
    first = samples[0]
    is_list = isinstance(first, (list, tuple))
    cols = list(zip(*samples)) if is_list else [samples]
    if any(isinstance(c[0], (list, tuple)) for c in cols):
        return None  # nested structure: rare, not worth a fast path
    off = 0
    views, metas = [], []
    for col in cols:
        a0 = _leaf_np(col[0])
        nbytes = int(_np.prod((len(col),) + a0.shape, dtype=_np.int64)) \
            * a0.dtype.itemsize
        off = (off + _ALIGN - 1) & ~(_ALIGN - 1)
        if off + nbytes > len(buf):
            return None
        shape = (len(col),) + a0.shape
        view = _np.frombuffer(buf, dtype=a0.dtype,
                              count=int(_np.prod(shape, dtype=_np.int64)),
                              offset=off).reshape(shape)
        views.append((view, a0, col))
        metas.append((off, shape, a0.dtype.str))
        off += nbytes
    for view, a0, col in views:
        view[0] = a0
        for i in range(1, len(col)):
            a = _leaf_np(col[i])
            if a.shape != a0.shape or a.dtype != a0.dtype:
                return None  # ragged: the generic path handles promotion
            view[i] = a
    return metas, is_list


def read_slot(buf, metas, is_list):
    """Parent-side: copy the collated arrays back out of a slot.

    The copy is what lets the slot be recycled immediately: a tensor
    made from a view of a ring slot that a worker will overwrite would
    alias it.  One memcpy still beats the 4+ copies of the pickle
    transport.
    """
    out = []
    for off, shape, dtype in metas:
        n = int(_np.prod(shape, dtype=_np.int64))
        out.append(_np.frombuffer(buf, dtype=_np.dtype(dtype), count=n,
                                  offset=off).reshape(shape).copy())
    return out if is_list else out[0]


def worker_loop(dataset, batchify_fn, slots, task_q, result_q,
                worker_init=None):
    """Worker main: pull (batch_idx, slot_id, sample_indices) tasks until
    the None sentinel.  Out-of-order by construction — any idle worker
    pops the next task, so one slow batch delays only itself.

    ``batchify_fn is None`` selects the built-in single-copy collation
    (the common case, and the one that collates straight into the slot).
    ``worker_init`` (picklable, called once before the first task) lets
    the parent set the child up, e.g. scope it to the host.
    """
    if worker_init is not None:
        worker_init()
    while True:
        task = task_q.get()
        if task is None:
            return
        batch_idx, slot_id, samples = task
        try:
            _maybe_data_fault(batch_idx)
            batch = [dataset[i] for i in samples]
            if batchify_fn is None:
                ok = _collate_into_slot(batch, slots[slot_id])
                if ok is not None:
                    metas, is_list = ok
                    result_q.put(("shm", batch_idx, slot_id, metas,
                                  is_list))
                    continue
                out = collate_samples(batch)
            else:
                out = batchify_fn(batch)
            result_q.put(("pickle", batch_idx, slot_id, out, None))
        except Exception as err:  # surfaced in the parent with context
            result_q.put(("error", batch_idx, slot_id,
                          (repr(err), traceback.format_exc(),
                           list(samples)), None))
