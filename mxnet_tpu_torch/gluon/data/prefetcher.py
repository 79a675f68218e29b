"""Device prefetch: pinned staging, a copy stream of its own, and events.

Counterpart of ``mxnet_tpu/gluon/data/prefetcher.py`` (the reference's
C++ PrefetcherIter with its copy stream).  ``DevicePrefetcher`` wraps any
iterable batch source (a gluon ``DataLoader``, an ``io.DataIter``, a
generator) and keeps ``MXTPU_DEVICE_PREFETCH`` (default 2) batches in
flight, already on the device, from a producer thread.

On the card each batch takes this path:

- **Pinned staging.** The producer collates the batch once into a slot
  of pinned host memory: a ``DataLoader`` hands over its samples
  uncollated and ``_shm_worker.collate_column(column, out=)`` writes them
  straight into the slot; other host leaves (numpy, CPU tensors, bf16
  included) are copied in.  The slots form a ring of ``depth + 1``; a
  slot goes back to the free list only after the event of the copy out
  of it has completed, so a copy in flight never reads memory the
  producer is rewriting.
- **The copy.** ``dst.copy_(slot, non_blocking=True)`` on a
  ``torch.cuda.Stream`` that belongs to the prefetcher: one host-to-device
  copy per array, and no other.  The producer thread enters the
  prefetcher's device and stream explicitly and records one event per
  batch.
- **The consumer.** ``__next__`` makes ``torch.cuda.current_stream()``
  wait on that batch's event and calls ``record_stream`` on each
  delivered tensor, so the caching allocator does not hand the batch's
  memory to the copy stream again while the step (an eager loop, or the
  copy into a captured step's static inputs) still reads it.

- **Samples already on the card** (a dataset held there, a transform run
  there by a worker thread, on that thread's stream) are stacked on the
  copy stream after it waits on the event the worker recorded when it
  fetched them; each sample is ``record_stream``ed on the copy stream,
  so its memory is not reused before the stack has read it.

A failed copy or event raises in the consumer's thread, as a source's
exception does; nothing falls back to the host or to the synchronous
path.  Other leaves already on the target device pass through.  Every
placement runs under ``profiler.annotate("h2d_prefetch")``.

The target is fixed in ``__iter__``, in the caller's thread: the mesh's
device, else ``current_context()``; the producer and the loader's
workers run under it.  ``MXTPU_DEVICE_PREFETCH=0`` (or
``depth=0``) places synchronously in the caller's thread: no thread, no
side stream.  On the host there is no copy engine: the async path runs
its producer thread without staging.

``sparse_tables=<block>`` adds the id prefetch of the recommender path:
for each batch it places, the producer thread reads the batch's ids
(after that batch's copy, on the copy stream) and computes every
``embedding.ShardedEmbedding``'s unique ids, inverse index and padding
(``embedding.prep.prepare_one``), stashed under the yielded batch for
the captured step to pop (``stash_prep``/``pop_prep``), so that work
overlaps the current step.

``mesh=`` names the target: a one-device mesh its device; a rank mesh
(one process a rank) this rank's card, and over its ``axis`` (dp) of n
ranks the rank keeps its block of rows of every array whose dim 0 n
divides (rank r rows [r B/n, (r+1) B/n), the reference's batch-dim
sharding), placing only those; an array n does not divide is placed
whole, replicated, as the reference places it.  With ``kvstore=`` and
``warm_pull={key: out}`` the producer thread also pulls, for every
sparse table whose parameter name is a key, the rows the batch it is
about to yield will touch (``row_sparse_pull(key, out, row_ids=...)``):
the store's local rows, no collective, so it never interleaves with the
step's all-reduce.
"""

from __future__ import annotations

import collections
import os
import queue as _queue
import threading
import time as _time

import numpy as _np
import torch

from ... import profiler
from ... import telemetry
from ...context import context_of, current_context
from ...ndarray.ndarray import NDArray, from_host
from .dataloader import (Samples, _batchify, _on_card, collate_pinned,
                         stack_samples, stage_host)


def default_depth():
    """Prefetch depth from MXTPU_DEVICE_PREFETCH (default 2 = double
    buffering: one batch on device waiting, one in transfer)."""
    try:
        return int(os.environ.get("MXTPU_DEVICE_PREFETCH", 2))
    except ValueError:
        return 2


def _mesh_context(mesh):
    """The Context this process places on: a one-device mesh's device, a
    rank mesh's device of this rank.  A mesh of several devices in one
    process raises (the port runs one process a rank)."""
    if getattr(mesh, "is_rank_mesh", False):
        return context_of(mesh.device)
    if mesh.size != 1:
        raise NotImplementedError(
            f"DevicePrefetcher: mesh {mesh.shape} spans {mesh.size} "
            "devices of one process; the port runs one process a rank "
            "(a rank mesh)")
    return context_of(mesh.devices.flat[0])


def _row_block(mesh, axis):
    """(n, r): the ranks over ``axis`` of a rank mesh and this rank's
    coordinate there; None for no mesh or an axis of one rank."""
    if mesh is None or not getattr(mesh, "is_rank_mesh", False):
        return None
    n = int(mesh.shape.get(axis, 1))
    return (n, mesh.coord(axis)) if n > 1 else None


def _rows_leaf(x, n, r):
    """Rank r's block of dim 0 of one leaf over n ranks; the leaf whole
    when n does not divide its dim 0 (or it has none)."""
    if isinstance(x, Samples):
        if len(x.samples) % n:
            return x
        b = len(x.samples) // n
        out = Samples.__new__(Samples)
        out.samples = x.samples[r * b:(r + 1) * b]
        out.cuda, out.ready = x.cuda, x.ready
        return out
    t = _tensor_of(x)
    shape = tuple(t.shape) if t is not None else getattr(x, "shape", ())
    if not shape or shape[0] % n:
        return x
    b = shape[0] // n
    if isinstance(x, NDArray):
        return NDArray(t[r * b:(r + 1) * b], x._ctx)
    return x[r * b:(r + 1) * b]


def shard_rows(batch, mesh, axis="dp"):
    """``batch`` with every array leaf cut to this rank's block of rows
    over ``mesh``'s ``axis`` (``_rows_leaf``); unchanged off a rank mesh
    or over an axis of one rank."""
    block = _row_block(mesh, axis)
    if block is None:
        return batch
    return _place(batch, None, lambda x: _rows_leaf(x, *block))


def _tensor_of(leaf):
    if isinstance(leaf, NDArray):
        return leaf._data
    if isinstance(leaf, torch.Tensor):
        return leaf
    return None


def _place_leaf(leaf, ctx):
    """One leaf on ``ctx``: one copy, or none when it is there already."""
    t = _tensor_of(leaf)
    if t is not None:
        if t.device == ctx.device:
            return leaf if isinstance(leaf, NDArray) else NDArray(t, ctx)
        if t.device.type == "cpu":
            return from_host(t.detach(), ctx)
        return NDArray(t.to(ctx.device), ctx)
    if isinstance(leaf, _np.ndarray):
        return from_host(leaf, ctx)
    return leaf


def _place(batch, ctx, leaf_fn):
    """``batch`` with every array leaf through ``leaf_fn``: NDArray /
    tensor / numpy leaves, (nested) lists and tuples, a loader's
    uncollated `Samples`, and ``io.DataBatch`` objects (data and label
    placed, pad and index kept).  Non-array leaves pass through."""
    if isinstance(batch, (NDArray, torch.Tensor, _np.ndarray)):
        return leaf_fn(batch)
    if isinstance(batch, Samples):
        return leaf_fn(batch)
    if isinstance(batch, (list, tuple)):
        placed = [_place(b, ctx, leaf_fn) for b in batch]
        return tuple(placed) if isinstance(batch, tuple) else placed
    if hasattr(batch, "data") and hasattr(batch, "label") \
            and hasattr(batch, "pad"):
        batch.data = [_place(d, ctx, leaf_fn) for d in batch.data] \
            if batch.data is not None else None
        batch.label = [_place(l, ctx, leaf_fn) for l in batch.label] \
            if batch.label is not None else None
        return batch
    return batch


def place(batch, mesh=None, axis="dp", ctx=None):
    """Place one batch's arrays on ``ctx`` (default: the mesh's device,
    else ``current_context()``) synchronously, one copy per array,
    preserving structure; a loader's uncollated samples are collated
    first.  Non-array leaves pass through."""
    if ctx is None:
        ctx = _mesh_context(mesh) if mesh is not None else current_context()

    def leaf(x):
        if isinstance(x, Samples):
            x.order()
            with ctx:
                return _batchify(x.samples, "device")
        return _place_leaf(x, ctx)

    with profiler.annotate("h2d_prefetch"):
        return _place(batch, ctx, leaf)


def _tensors(batch, out):
    """Every tensor a placed batch delivers."""
    if isinstance(batch, NDArray):
        out.append(batch._data)
    elif isinstance(batch, (list, tuple)):
        for b in batch:
            _tensors(b, out)
    elif hasattr(batch, "data") and hasattr(batch, "label") \
            and hasattr(batch, "pad"):
        _tensors(batch.data or [], out)
        _tensors(batch.label or [], out)
    return out


class _Slot:
    """One batch's pinned staging: a byte buffer per array of the batch,
    grown as needed, and the host tensors a copy reads in place."""

    def __init__(self):
        self.bufs = []
        self.keep = []
        self.n = 0

    def view(self, shape, dtype):
        """The next array's staging, ``shape`` of ``dtype``, pinned."""
        nbytes = int(_np.prod(shape, dtype=_np.int64)) * \
            torch.empty(0, dtype=dtype).element_size()
        i, self.n = self.n, self.n + 1
        if i == len(self.bufs):
            self.bufs.append(None)
        if self.bufs[i] is None or self.bufs[i].numel() < nbytes:
            self.bufs[i] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                       pin_memory=True)
        return self.bufs[i][:nbytes].view(dtype).view(shape)


class _PinnedStage:
    """The card's half of the prefetcher: a ring of ``depth + 1`` pinned
    slots, the copy stream, and one event per batch.  Used only from the
    producer thread."""

    def __init__(self, depth, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._free = collections.deque(_Slot() for _ in range(depth + 1))
        self._busy = collections.deque()     # (slot, event), oldest first

    def _take(self):
        """A free slot: those whose copy has completed go back to the
        free list first; with none free, wait for the oldest copy."""
        while self._busy and self._busy[0][1].query():
            self._free.append(self._busy.popleft()[0])
        if not self._free:
            slot, event = self._busy.popleft()
            event.synchronize()
            self._free.append(slot)
        slot = self._free.popleft()
        slot.keep, slot.n = [], 0
        return slot

    def _copy(self, src):
        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        dst.copy_(src, non_blocking=True)
        return dst

    def _stage_column(self, slot, column):
        """Collate one column of samples into the slot, then copy it;
        samples on the card are stacked there."""
        if _on_card(column[0]):
            return stack_samples(column, self.device)
        return self._copy(collate_pinned(column, slot.view))

    def _stage_host(self, slot, x):
        """One host array (numpy or a CPU tensor) through the slot."""
        if isinstance(x, torch.Tensor):
            if x.is_pinned():
                slot.keep.append(x)    # read in place until the event
                return self._copy(x)
            pinned = slot.view(tuple(x.shape), x.dtype)
            pinned.copy_(x)
            return self._copy(pinned)
        return self._copy(stage_host(x, slot.view))

    def _stage_samples(self, slot, samples):
        """A loader's uncollated batch, structured as its batchify would
        have: a list of columns for tuple samples, else one array."""
        if isinstance(samples[0], tuple):
            return [self._stage_samples(slot, list(col))
                    for col in zip(*samples)]
        return self._stage_column(slot, samples)

    def place(self, batch, ctx):
        """Stage and copy one batch on the copy stream (the caller has it
        current); returns the placed batch and its event."""
        slot = self._take()

        def leaf(x):
            if isinstance(x, Samples):
                x.order(self.stream)
                return _wrap(self._stage_samples(slot, x.samples), ctx)
            t = _tensor_of(x)
            if t is not None and t.device.type != "cpu":
                return _place_leaf(x, ctx)
            host = t.detach() if t is not None else x
            return NDArray(self._stage_host(slot, host), ctx)

        with profiler.annotate("h2d_prefetch"):
            placed = _place(batch, ctx, leaf)
        event = torch.cuda.Event()
        event.record(self.stream)
        self._busy.append((slot, event))
        return placed, event


def _wrap(staged, ctx):
    if isinstance(staged, list):
        return [_wrap(s, ctx) for s in staged]
    return NDArray(staged, ctx)


class _EndOfEpoch:
    pass


_END = _EndOfEpoch()


class DevicePrefetcher:
    """Wrap a batch source; deliver device-placed batches with overlap.

    Parameters
    ----------
    data : iterable
        DataLoader, DataIter, or any iterable of batches.  Re-iterated
        from scratch on every ``__iter__`` (call ``reset()`` between
        epochs for DataIter sources, as with the bare iterator).
    depth : int, optional
        Batches to keep in flight; default ``MXTPU_DEVICE_PREFETCH``
        (2).  ``0`` = synchronous placement, no background thread.
    mesh, axis :
        A one-device mesh names the target device; without one the
        target is the context current where ``iter()`` runs.
    sparse_tables : Block, optional
        A block tree holding ``embedding.ShardedEmbedding`` children: the
        producer thread computes each table's id prep for the batch it is
        about to yield and stashes it for the captured step.
    kvstore, warm_pull :
        With a kvstore and ``warm_pull={key: out}``, the producer also
        issues ``row_sparse_pull(key, out, row_ids=<next batch's ids>)``
        for every table whose parameter name matches ``key``.
    """

    def __init__(self, data, depth=None, mesh=None, axis="dp",
                 sparse_tables=None, kvstore=None, warm_pull=None):
        self._sparse_block = sparse_tables
        self._kvstore = kvstore
        self._warm_pull = dict(warm_pull or {})
        self._data = data
        self._depth = default_depth() if depth is None else int(depth)
        self._mesh = mesh
        self._axis = axis
        if mesh is not None:
            _mesh_context(mesh)     # several devices of one process raise
        self._stop = None
        self._thread = None

    def _target(self):
        if self._mesh is not None:
            return _mesh_context(self._mesh)
        return current_context()

    def __len__(self):
        return len(self._data)

    @property
    def batch_size(self):
        return getattr(self._data, "batch_size", None)

    @property
    def provide_data(self):
        return self._data.provide_data

    @property
    def provide_label(self):
        return self._data.provide_label

    def reset(self):
        """Stop any in-flight epoch and reset the wrapped source."""
        self._shutdown()
        if hasattr(self._data, "reset"):
            self._data.reset()

    def close(self):
        self._shutdown()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass

    def _shutdown(self):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._stop = None
        self._thread = None
        if self._sparse_block is not None:
            from ...embedding import prep as _prep

            _prep.clear_stash()

    def _prep_sparse(self, placed):
        """The id prep of the batch about to be yielded, stashed under its
        data array for ``embedding.prep.pop_prep``."""
        if self._sparse_block is None:
            return
        from ...embedding import prep as _prep

        data = _batch_data(placed)
        tables = _prep.find_sparse_embeddings(self._sparse_block)
        if data is None or not tables:
            return
        t0 = _time.perf_counter()
        preps = {}
        for pid, blk in tables.items():
            pr = _prep.prepare_one(data, blk)
            if pr is not None:
                preps[pid] = pr
            dest = self._warm_pull.get(blk.weight.name) \
                if self._kvstore is not None else None
            if dest is not None:
                ids = pr.uniq[:pr.n_real] if pr is not None \
                    else _np.unique(_prep.extract_ids(
                        data, blk._feature, blk._input_dim))
                self._kvstore.row_sparse_pull(blk.weight.name, out=dest,
                                              row_ids=ids)
                telemetry.count("input.warm_pulls")
        if preps:
            _prep.stash_prep(data, preps)
        telemetry.count("input.id_prep_us",
                        int((_time.perf_counter() - t0) * 1e6))

    # -- resumable pipeline state (gluon/data/state.py) ------------------------

    def state_dict(self):
        """The wrapped source's position.  Delivery-exact by
        construction: the source's cursor advances when *this* wrapper
        delivers a batch downstream, not when the producer thread
        prefetches it."""
        return self._data.state_dict()

    def load_state_dict(self, sd):
        """Restore never consumes a stale pre-restore batch: the producer
        thread is stopped and its in-flight batches discarded BEFORE the
        source adopts the new cursor."""
        self._shutdown()
        self._data.load_state_dict(sd)
        return self

    def quarantine(self, batch_ids):
        """Delegate to the wrapped loader (see DataLoader.quarantine)."""
        return self._data.quarantine(batch_ids)

    def last_batch_id(self):
        """(epoch, batch_idx) of the last batch DELIVERED downstream, or
        None."""
        return self._data.last_batch_id()

    @property
    def samples_seen(self):
        return self._data.samples_seen

    def __iter__(self):
        self._shutdown()
        ctx = self._target()
        if self._depth <= 0:
            return self._sync_iter(ctx)
        return self._async_iter(ctx)

    def _sync_iter(self, ctx):
        with ctx:
            it = iter(self._data)
        while True:
            # consumer-thread stall: fetching + placing the batch happens
            # inline, so the whole span is time the step loop waited
            t0 = _time.perf_counter()
            try:
                with ctx:
                    batch = next(it)
            except StopIteration:
                return
            placed = place(shard_rows(batch, self._mesh, self._axis),
                           ctx=ctx)
            self._prep_sparse(placed)
            telemetry.count("input.wait_us",
                            int((_time.perf_counter() - t0) * 1e6))
            telemetry.count("input.batches")
            yield placed

    def _async_iter(self, ctx):
        q = _queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        cuda = ctx.device_type == "gpu"
        stage = _PinnedStage(self._depth, ctx.device) if cuda else None
        # a loader hands over its samples uncollated (or, from process
        # workers, collated host arrays); other sources as they come
        if hasattr(self._data, "_host_iter"):
            src = self._data._host_iter(ctx)
        else:
            with ctx:
                src = iter(self._data)
        # resumable sources: the producer runs ahead of the training
        # loop, so each batch travels with its commit token and the state
        # advances only when the consumer below delivers it.  Tokens of
        # batches a teardown discards are never committed.
        acct = src if hasattr(src, "defer_accounting") else None
        if acct is not None:
            acct.defer_accounting()

        def produce():
            for batch in src:
                batch = shard_rows(batch, self._mesh, self._axis)
                if cuda:
                    placed, event = stage.place(batch, ctx)
                else:
                    placed, event = place(batch, ctx=ctx), None
                self._prep_sparse(placed)
                token = acct.take_token() if acct is not None else None
                if not _put(q, stop, (placed, event, token)):
                    return
            token = acct.take_token() if acct is not None else None
            _put(q, stop, (_END, None, token))

        def producer():
            try:
                with ctx:
                    if cuda:
                        with torch.cuda.device(ctx.device), \
                                torch.cuda.stream(stage.stream):
                            produce()
                    else:
                        produce()
            except BaseException as err:  # forwarded to the consumer
                _put(q, stop, err)

        t = threading.Thread(target=producer, daemon=True,
                             name="mxtpu-device-prefetch")
        self._stop, self._thread = stop, t
        t.start()
        try:
            while True:
                # consumer-thread stall: only the q.get wait counts
                t0 = _time.perf_counter()
                while True:
                    try:
                        item = q.get(timeout=0.2)
                        break
                    except _queue.Empty:
                        if not t.is_alive() and q.empty():
                            return  # producer died without posting (rare)
                        continue
                telemetry.count("input.wait_us",
                                int((_time.perf_counter() - t0) * 1e6))
                if isinstance(item, BaseException):
                    raise item
                placed, event, token = item
                if event is not None:
                    cur = torch.cuda.current_stream(ctx.device)
                    cur.wait_event(event)
                    for x in _tensors(placed, []):
                        if x.is_cuda:
                            x.record_stream(cur)
                if acct is not None and token is not None:
                    acct.commit(token)   # delivery-time accounting
                if placed is _END:
                    return
                telemetry.count("input.batches")
                telemetry.gauge_set("input.queue_depth", q.qsize())
                yield placed
        finally:
            stop.set()
            while not q.empty():  # unblock a producer stuck on put
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            t.join(timeout=5)
            close = getattr(src, "close", None)
            if close is not None and not t.is_alive():
                close()
            if self._thread is t:
                self._stop, self._thread = None, None


def _batch_data(batch):
    """The data array of a batch: an NDArray itself, the first element of
    a tuple or list, a DataBatch's first data array."""
    if isinstance(batch, NDArray):
        return batch
    if isinstance(batch, (list, tuple)) and batch:
        return _batch_data(batch[0])
    if hasattr(batch, "data") and hasattr(batch, "label"):
        return _batch_data(batch.data[0]) if batch.data else None
    return None


def _put(q, stop, item):
    """Bounded put that gives up when the consumer abandoned the epoch."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False
