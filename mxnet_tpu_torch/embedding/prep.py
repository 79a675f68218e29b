"""Host-side id preparation for captured sparse-embedding steps.

Counterpart of ``mxnet_tpu/embedding/prep.py``.  A CUDA graph has static
shapes and cannot run ``torch.unique`` (which sizes its output on the
host), so the host computes, per step and per table:

    ids  = clip(int(feature-slice(batch)), 0, vocab-1).ravel()
    uniq, inv = np.unique(ids, return_inverse=True)

(the cast-then-clip order of the eager ``ops.indexing.sparse_embedding``,
so both paths agree on the row every id reads), then pads ``uniq`` to a
power-of-two bucket.  The JAX package pads with the out-of-range id
``vocab`` and relies on its scatter dropping out-of-bounds rows; a torch
scatter raises there instead (a device-side assert on the card).  Here
the padding repeats the last real id, and ``src`` maps every padded slot
to that id's real slot: the row update writes each padded slot with the
real slot's new row and states (``optimizer.grouped.step_group``), so
the duplicate writes carry the same bits, and no padded slot applies an
update of its own (Adam would move a row on a zero gradient).  The
bucket joins the capture key: recordings are bounded by the distinct
buckets, not by per-batch unique counts.

``DevicePrefetcher(sparse_tables=)``'s producer thread calls
``prepare_one`` one batch ahead and stashes the result
(``stash_prep``/``pop_prep``), taking the unique/inverse work (and the
read of the ids to the host) off the step.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as _np
import torch


def sparse_captured_enabled() -> bool:
    """MXTPU_SPARSE_CAPTURED gate (default on); 0/false/off pins
    sparse_grad=True configurations to the eager row-sparse oracle."""
    return os.environ.get("MXTPU_SPARSE_CAPTURED", "1").lower() \
        not in ("0", "false", "off", "")


def unique_bucket_env() -> int:
    """MXTPU_UNIQUE_BUCKET: a fixed unique-count bucket (one capture
    signature for every batch whose unique count fits), or 0 (default)
    for the next power of two."""
    try:
        return max(0, int(os.environ.get("MXTPU_UNIQUE_BUCKET", "0")))
    except ValueError:
        return 0


def bucket_for(n_real: int):
    """The padded unique-count bucket for ``n_real`` unique ids: the fixed
    MXTPU_UNIQUE_BUCKET when set (None when the batch does not fit: the
    caller falls back to the eager oracle, with a telemetry reason), else
    the next power of two."""
    fixed = unique_bucket_env()
    if fixed:
        return fixed if n_real <= fixed else None
    b = 1
    while b < max(int(n_real), 1):
        b *= 2
    return b


class SparsePrep:
    """One table's host-prepared lookup indices for one batch."""

    __slots__ = ("uniq", "src", "inv", "bucket", "n_real", "n_ids", "vocab")

    def __init__(self, uniq, src, inv, bucket, n_real, n_ids, vocab):
        self.uniq = uniq          # np.int64 (bucket,), padded with uniq[-1]
        self.src = src            # np.int64 (bucket,): slot -> its real slot
        self.inv = inv            # np.int64 (n_ids,) into uniq
        self.bucket = int(bucket)
        self.n_real = int(n_real)
        self.n_ids = int(n_ids)
        self.vocab = int(vocab)


def _n_ids_of(shape, feature):
    """The flat id count a batch shape yields under a feature selector."""
    n = 1
    if feature is None:
        for d in shape:
            n *= int(d)
        return n
    for d in shape[:-1]:
        n *= int(d)
    if isinstance(feature, slice):
        start, stop, step = feature.indices(int(shape[-1]))
        return n * len(range(start, stop, step))
    return n


def _host_array(data):
    t = getattr(data, "_data", data)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return _np.asarray(t)


def extract_ids(data, feature, vocab):
    """Flat clipped int64 ids of a batch, the host twin of the eager op's
    ``clamp(long(x), 0, vocab-1)`` (cast, truncating toward zero, then
    clip).  A batch on the card is read to the host here."""
    arr = _host_array(data)
    if feature is not None:
        arr = arr[..., feature]
    return _np.clip(arr.astype(_np.int64), 0, vocab - 1).ravel()


def prepare_one(data, block):
    """``SparsePrep`` for one ShardedEmbedding on one batch, or None when
    the unique count exceeds a fixed MXTPU_UNIQUE_BUCKET."""
    vocab = block._input_dim
    ids = extract_ids(data, block._feature, vocab)
    uniq, inv = _np.unique(ids, return_inverse=True)
    n = int(uniq.shape[0])
    if n == 0:
        raise ValueError("ShardedEmbedding: a batch with no ids")
    bucket = bucket_for(n)
    if bucket is None:
        return None
    padded = _np.full((bucket,), uniq[-1], _np.int64)
    padded[:n] = uniq
    src = _np.minimum(_np.arange(bucket, dtype=_np.int64), n - 1)
    return SparsePrep(uniq=padded, src=src,
                      inv=inv.astype(_np.int64).ravel(), bucket=bucket,
                      n_real=n, n_ids=ids.size, vocab=vocab)


def find_sparse_embeddings(block):
    """{id(table param): ShardedEmbedding} over a block tree."""
    from .sharded import ShardedEmbedding

    found = {}

    def walk(b):
        if isinstance(b, ShardedEmbedding) and b._sparse_grad:
            found[id(b.weight)] = b
        for child in getattr(b, "_children", {}).values():
            walk(child)

    walk(block)
    return found


def sparse_capture_reason(trainer, block, sparse_params):
    """Why row-sparse params cannot enter the captured step, or None.
    ``sparse_params``: [(trainer index, Parameter)] with a row_sparse
    grad_stype.  The string is also the ``sparse_fallback`` event's
    reason."""
    from ..optimizer import optimizer as _optmod

    if not sparse_captured_enabled():
        return "sparse capture disabled (MXTPU_SPARSE_CAPTURED=0)"
    o = trainer._optimizer
    if type(o) not in (_optmod.SGD, _optmod.Adam):
        return f"optimizer {type(o).__name__} has no row-sparse " \
               "fused plan"
    if not getattr(o, "lazy_update", True):
        return "lazy_update=False densifies row-sparse gradients"
    emb = find_sparse_embeddings(block)
    for _i, p in sparse_params:
        if id(p) not in emb:
            return "sparse_grad=True parameter outside ShardedEmbedding"
        if o._mp_weight(p.data()):
            return "multi-precision row-sparse table"
    return None


def _prep_valid(pr, data, block):
    """A stashed prep is usable only if it still describes this batch's
    shape, this table and the bucket policy (the env knob may have
    moved)."""
    return (isinstance(pr, SparsePrep)
            and pr.vocab == block._input_dim
            and pr.n_ids == _n_ids_of(data.shape, block._feature)
            and bucket_for(pr.n_real) == pr.bucket)


def prepare_step(block, data, sparse_params):
    """Per-step host prep for every sparse table, stash-aware.  Returns
    ``(preps, reason, lookup_us)``: ``preps`` aligned with
    ``sparse_params`` (None, with a ``reason``, on fallback);
    ``lookup_us`` is the host time spent here, down to the pop when the
    producer thread prepared the batch."""
    t0 = time.perf_counter()
    cached = pop_prep(data) or {}
    emb = find_sparse_embeddings(block)
    preps = []
    for _i, p in sparse_params:
        b = emb.get(id(p))
        if b is None:
            return (None,
                    "sparse_grad=True parameter outside ShardedEmbedding",
                    (time.perf_counter() - t0) * 1e6)
        pr = cached.get(id(p))
        if pr is not None and not _prep_valid(pr, data, b):
            pr = None
        if pr is None:
            pr = prepare_one(data, b)
        if pr is None:
            return (None,
                    "unique count exceeds MXTPU_UNIQUE_BUCKET="
                    f"{unique_bucket_env()}",
                    (time.perf_counter() - t0) * 1e6)
        preps.append(pr)
    return preps, None, (time.perf_counter() - t0) * 1e6


# -- prefetcher handoff (gluon/data/prefetcher.py's producer thread) ------------
#
# Keyed by the identity of the batch object the prefetcher yields, holding
# a strong reference so the id cannot be recycled while the entry lives;
# one-shot pop on the consumer side; bounded, first in first out, so an
# abandoned iterator cannot leak.

_PREP_CACHE = {}
_PREP_CACHE_MAX = 8


def stash_prep(data_nd, preps):
    """Producer side: remember ``{id(table param): SparsePrep}`` for a
    batch about to be yielded."""
    while len(_PREP_CACHE) >= _PREP_CACHE_MAX:
        _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
    _PREP_CACHE[id(data_nd)] = (data_nd, dict(preps))


def pop_prep(data_nd):
    """Consumer side: the stashed preps for exactly this batch object, or
    None.  One-shot."""
    entry = _PREP_CACHE.pop(id(data_nd), None)
    if entry is None or entry[0] is not data_nd:
        return None
    return entry[1]


def clear_stash():
    """Drop every stashed prep (prefetcher teardown): a prep must never
    pair with a batch of another epoch."""
    _PREP_CACHE.clear()


# -- the captured step's lookup -------------------------------------------------
#
# While gluon/captured.py runs a sparse step it maps each table param's id
# to (the gathered unique rows, the microbatch's inverse index);
# ShardedEmbedding.hybrid_forward switches on the entry's presence.

_SCOPE = {}


@contextmanager
def capture_scope(mapping):
    saved = dict(_SCOPE)
    _SCOPE.update(mapping)
    try:
        yield
    finally:
        _SCOPE.clear()
        _SCOPE.update(saved)


def scope_entry(param_id):
    return _SCOPE.get(param_id)


class _RowsLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, inv):
        ctx.save_for_backward(inv)
        ctx.n_rows = rows.shape[0]
        return rows.index_select(0, inv)

    @staticmethod
    def backward(ctx, ct):
        from ..ndarray.sparse import segment_sum

        (inv,) = ctx.saved_tensors
        return segment_sum(ct.contiguous(), inv, ctx.n_rows), None


def rows_lookup(rows, inv, out_shape):
    """The captured step's lookup over the pre-gathered unique rows, with
    the eager op's backward math.  Forward: ``rows[inv]``, composed with
    the gather ``table[uniq]`` the same elements the eager
    ``table[clipped ids]`` reads (pure data movement).  Backward: the
    cotangents summed per unique row by ``ndarray.sparse.segment_sum``, in
    f32 and cast back, as ``sparse_embedding``'s backward sums them.  A
    padded slot is a segment no ``inv`` entry targets: its gradient row is
    exactly zero."""
    return _RowsLookup.apply(rows, inv).reshape(out_shape)
