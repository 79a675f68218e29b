"""DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference:
python/mxnet/gluon/data/dataloader.py): DataLoader with batchify
(``default_batchify_fn``), samplers, ``last_batch``, ``prefetch``,
``timeout`` and multi-worker loading, plus the JAX package's resumable
``seed=``/``rank``/``world_size`` state API.

- **Single-copy collation**: ``default_batchify_fn`` collates samples into
  one contiguous host buffer and makes ONE copy per batch array to the
  device (``ndarray.from_host``): a bare loader returns NDArrays on the
  context that was current where ``iter(loader)`` ran, as the reference's
  does.  ``pin_memory=True`` collates straight into pinned host memory
  instead and returns CPU NDArrays (MXNet's ``cpu_pinned``; without a
  card there is no pinned memory and the batch is plain host memory).
  Wrapped in ``DevicePrefetcher`` (prefetcher.py), the loader hands the
  prefetcher its samples uncollated, and the prefetcher collates them
  once into its pinned ring and makes the one copy on its own stream.
- **The context is captured in ``__iter__``**, in the caller's thread, and
  every worker thread runs under it: a context is thread-local, and a
  worker that read its own would see the default ``gpu(0)`` even inside
  the caller's ``with mx.cpu():``.
- **Workers**: a thread pool by default; ``thread_pool=False`` with
  num_workers>0 spawns processes (``multiprocessing`` "spawn") that
  transport batches through shared-memory ring slots
  (``_shm_worker.py``) with out-of-order completion and in-order
  delivery.  A child runs under ``cpu()`` and never initialises CUDA;
  the default batchify is passed to it as None (the built-in collation).
  ``MXTPU_SHM_SLOT_MB`` sizes the slots; oversized batches fall back to
  pickling.
- ``seed=`` makes the loader resumable (``state.DataPipelineState``): the
  order is a pure function of ``(seed, epoch)``, ``state_dict()`` /
  ``load_state_dict()`` carry the position, and quarantined batches are
  skipped loudly on replay (a ``DivergenceMonitor`` rollback rewinds the
  loader and quarantines the streak's batches).  ``MXTPU_DATA_TIMEOUT``
  is the receive watchdog for worker batches.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import queue as _queue
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as _np
import torch

from ... import resilience as _resilience
from ... import telemetry as _telemetry
from ...context import cpu, current_context
from ...ndarray.ndarray import NDArray, from_host, host_dtype
from . import sampler as _sampler
from . import _shm_worker
from .state import DataPipelineState


class DataLoaderWorkerError(RuntimeError):
    """A dataset ``__getitem__``/batchify raised inside a loader worker.

    Carries the failing batch's sample indices and (for process workers)
    the worker-side traceback, instead of the opaque pickling/timeout
    error the raw transport would produce."""


class Samples:
    """One batch's samples, fetched but not collated: what a loader hands
    ``DevicePrefetcher``, which collates them into its pinned staging.

    Samples already on the card (a dataset held there, a transform that
    ran there) were made on the stream current in the thread that fetched
    them; ``ready`` is an event recorded there, and `order` makes the
    stream that stacks them wait for it."""

    __slots__ = ("samples", "cuda", "ready")

    def __init__(self, samples):
        self.samples = samples
        self.cuda = _card_tensors(samples, [])
        self.ready = None
        if self.cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(self.cuda[0].device))

    def order(self, stream=None):
        """Make ``stream`` (default: the current one) wait until the
        samples are written, and keep their memory from the caching
        allocator until what ``stream`` has queued by their release has
        read them."""
        if self.ready is None:
            return
        stream = stream or torch.cuda.current_stream(self.cuda[0].device)
        stream.wait_event(self.ready)
        for t in self.cuda:
            t.record_stream(stream)


def _card_tensors(samples, out):
    """The card tensors among (nested) samples."""
    for s in samples:
        if isinstance(s, (tuple, list)):
            _card_tensors(s, out)
        else:
            t = s._data if isinstance(s, NDArray) else s
            if isinstance(t, torch.Tensor) and t.is_cuda:
                out.append(t)
    return out


def _on_card(sample):
    return isinstance(sample, NDArray) and sample._data.device.type != "cpu"


def stack_samples(column, device):
    """Samples that sit on the card, stacked on ``device`` on the current
    stream: stacking on the device beats a readback."""
    return torch.stack([s._data.to(device) for s in column])


def _torch_dtype(dtype):
    return torch.from_numpy(_np.empty(0, dtype)).dtype


def stage_host(arr, alloc):
    """One host array copied into ``alloc(shape, dtype)``'s memory (a
    pinned tensor), in ``host_dtype``."""
    arr = _np.asarray(arr)
    out = alloc(arr.shape, _torch_dtype(host_dtype(arr.dtype)))
    _np.copyto(out.numpy(), arr, casting="unsafe")
    return out


def collate_pinned(column, alloc):
    """Collate one column of host samples once, straight into
    ``alloc(shape, dtype)``'s memory (a fresh pinned tensor, or a slot of
    the prefetcher's ring), in ``host_dtype``."""
    arrs = [_shm_worker._leaf_np(a) for a in column]
    a0 = arrs[0]
    if any(a.shape != a0.shape or a.dtype != a0.dtype for a in arrs[1:]):
        return stage_host(_np.asarray(arrs), alloc)   # the legacy promotion
    out = alloc((len(arrs),) + a0.shape, _torch_dtype(host_dtype(a0.dtype)))
    _shm_worker.collate_column(arrs, out=out.numpy())
    return out


def _pinned_empty(shape, dtype):
    """Pinned host memory (plain host memory without a card: only where
    there is one can host memory be pinned)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())


def _batchify(data, mode):
    """The built-in batchify of each mode: ``device`` (one copy per array
    to the current context), ``pinned`` (pinned CPU batches) or
    ``samples`` (uncollated, for ``DevicePrefetcher``)."""
    if mode == "samples":
        return Samples(data)
    if _on_card(data[0]):
        return NDArray(stack_samples(data, data[0]._data.device),
                       data[0].context)
    if isinstance(data[0], tuple):
        return [_batchify(list(col), mode) for col in zip(*data)]
    if mode == "pinned":
        return NDArray(collate_pinned(data, _pinned_empty), cpu())
    return from_host(_shm_worker.collate_column(data), own=True)


def default_batchify_fn(data):
    """Stack samples into a batch (reference: default_batchify_fn).

    Collates on the host into one contiguous buffer per output array and
    makes a single copy per array to ``current_context()``."""
    return _batchify(data, "device")


def default_mp_batchify_fn(data):
    """Batchify in a worker: keep numpy (single-copy collation into a
    contiguous buffer); the parent makes one copy per array."""
    return _shm_worker.collate_samples(data)


class _HostScope:
    """Picklable ``worker_init`` of a spawned child: scope it to the host,
    so a dataset that makes NDArrays there never initialises CUDA."""

    def __call__(self):
        cpu().__enter__()


class _Worker:
    """Per-batch fetch closure for pool threads, run under the context
    captured in ``__iter__``."""

    def __init__(self, dataset, batchify_fn, ctx):
        self._dataset = dataset
        self._batchify_fn = batchify_fn
        self._ctx = ctx

    def __call__(self, samples, batch_idx=None):
        with self._ctx:
            if batch_idx is not None:
                # worker_hang:K / data_skew:K fault sites (thread
                # transport; _shm_worker mirrors this for spawn workers)
                _resilience.maybe_data_fault(batch_idx)
            return self._batchify_fn([self._dataset[i] for i in samples])


class DataLoader:
    """Loads mini-batches from a Dataset (reference: gluon.data.DataLoader).

    Parameters follow the reference: dataset, batch_size, shuffle, sampler,
    last_batch ('keep'|'discard'|'rollover'), batch_sampler, batchify_fn,
    num_workers, pin_memory (pinned CPU batches), pin_device_id, prefetch
    (None -> 2*num_workers; 0 -> at most one batch in flight), thread_pool,
    timeout.

    Resumable loading (``gluon/data/state.py``):

    - ``seed``: the sample order becomes a pure function of ``(seed,
      epoch)``, and the loader exposes ``state_dict()/load_state_dict()``
      (epoch, global sample cursor, quarantined batches); replay skips
      quarantined batches with one ``batch_quarantined`` telemetry event
      each.
    - ``rank``/``world_size``: this loader's slice of the global order
      (``order[cursor:][rank::world]``).  A restored state keeps the
      LOCAL rank/world, so loading an N-rank state into an M-rank loader
      re-shards the remaining epoch with zero re-read and zero skipped
      samples.
    - ``MXTPU_DATA_TIMEOUT`` (seconds, default = ``timeout``): receive
      watchdog for worker batches — a hung worker raises
      `DataLoaderWorkerError` naming the batch.
    """

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=True, timeout=120,
                 seed=None, rank=0, world_size=1):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._state = None

        if seed is not None:
            if batch_sampler is not None or sampler is not None:
                raise ValueError(
                    "seed= (resumable loading) builds its own sampler; "
                    "it cannot be combined with sampler= or "
                    "batch_sampler=")
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified with seed=")
            self._state = DataPipelineState(
                len(dataset), seed=seed, shuffle=shuffle,
                rank=rank, world=world_size)
            sampler = _sampler.ResumableSampler(self._state)
            shuffle = False   # the ResumableSampler owns the order

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = _sampler.RandomSampler(len(dataset))
                else:
                    sampler = _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")

        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._custom_batchify = batchify_fn is not None
        if batchify_fn is None:
            if num_workers > 0 and not thread_pool:
                self._batchify_fn = default_mp_batchify_fn
            else:
                self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn

    def __iter__(self):
        mode = "pinned" if self._pin_memory else "device"
        ctx = cpu() if self._pin_memory else current_context()
        return self._iter(mode, ctx)

    def _host_iter(self, ctx):
        """The iterator ``DevicePrefetcher`` drives: built-in batchify
        output as uncollated `Samples` (process workers: collated host
        arrays), custom batchify output as it comes; worker threads run
        under ``ctx``."""
        return self._iter("samples", ctx)

    def _iter(self, mode, ctx):
        if self._state is None:
            return self._raw_iter(iter(self._batch_sampler), mode, ctx)
        return _ResumableIter(self, mode, ctx)

    def _batchify_for(self, mode):
        if self._custom_batchify or mode == "device":
            return self._batchify_fn
        if self._num_workers > 0 and not self._thread_pool:
            return default_mp_batchify_fn
        return lambda data: _batchify(data, mode)

    def _raw_iter(self, batches, mode, ctx):
        """The transport-level iterator over an index-batch stream."""
        if self._num_workers == 0:
            fn = self._batchify_for(mode)

            def same_process_iter():
                for batch in batches:
                    with ctx:
                        ret = fn([self._dataset[idx] for idx in batch])
                    yield ret
            return same_process_iter()
        return _MultiWorkerIter(self, batches, mode, ctx)

    def __len__(self):
        return len(self._batch_sampler)

    # -- resumable pipeline state (gluon/data/state.py) ------------------------

    def _require_state(self, what):
        if self._state is None:
            raise RuntimeError(
                f"DataLoader.{what}: construct the loader with seed= to "
                f"make it resumable")
        return self._state

    def state_dict(self):
        """JSON-serializable pipeline position (delivery-exact: never
        counts prefetched-but-undelivered batches)."""
        return self._require_state("state_dict").state_dict()

    def load_state_dict(self, sd):
        """Adopt a checkpointed position; the next ``__iter__`` resumes
        at the exact sample offset (zero re-read, zero skipped).  The
        loader's own rank/world are kept."""
        st = self._require_state("load_state_dict")
        st.load_state_dict(sd)
        _telemetry.event("data_resume", epoch=st.epoch, cursor=st.cursor,
                         samples_seen=st.samples_seen,
                         reread_samples=0, skipped_samples=0,
                         world=st.world, loader_rank=st.rank)
        return self

    def quarantine(self, batch_ids):
        """Mark ``(epoch, batch_idx)`` batch ids to be skipped (loudly)
        on replay."""
        self._require_state("quarantine").quarantine(batch_ids)

    def last_batch_id(self):
        """``(epoch, batch_idx)`` of the newest delivered batch."""
        return self._require_state("last_batch_id").last_delivered

    @property
    def samples_seen(self):
        return self._require_state("samples_seen").samples_seen


def _slot_bytes():
    return int(float(os.environ.get("MXTPU_SHM_SLOT_MB", 32)) * (1 << 20))


def _place_host(out, mode, ctx):
    """A process worker's host batch (numpy, nested in a list) in the
    loader's mode: one copy per array to ``ctx``, pinned CPU arrays, or
    as is for the prefetcher."""
    if mode == "samples":
        return out
    if isinstance(out, list):
        return [_place_host(o, mode, ctx) for o in out]
    if mode == "pinned":
        return NDArray(stage_host(out, _pinned_empty), cpu())
    return from_host(out, ctx, own=True)


class _MultiWorkerIter:
    """Prefetching iterator over pool workers.

    Thread pool: futures are delivered in submit order; the executor runs
    them concurrently.  Process pool: workers pull from a shared task
    queue (out-of-order completion), results are reordered in the parent
    so delivery matches the sampler order — identical batches, identical
    order, regardless of transport.

    The iterator owns OS resources; it cleans up on exhaustion, on
    ``close()``, on ``__del__`` (abandoned mid-epoch), and supports use
    as a context manager.
    """

    def __init__(self, loader, batches, mode, ctx):
        self._loader = loader
        self._batches = iter(batches)
        self._mode = mode
        self._ctx = ctx
        self._data_timeout = float(
            os.environ.get("MXTPU_DATA_TIMEOUT", loader._timeout))
        self._depth = max(1, loader._prefetch)
        self._sent_idx = 0
        self._rcvd_idx = 0
        self._data_buffer = {}  # batch_idx -> result record
        self._closed = False
        self._pool = None
        self._procs = []
        if loader._thread_pool:
            self._worker = _Worker(loader._dataset,
                                   loader._batchify_for(mode), ctx)
            self._pool = ThreadPoolExecutor(max_workers=loader._num_workers)
        else:
            self._start_processes(loader)
        for _ in range(self._depth):
            self._push_next()

    # -- process transport -----------------------------------------------------

    def _start_processes(self, loader):
        mp = multiprocessing.get_context("spawn")
        nslots = max(self._depth, loader._num_workers)
        self._slots = [mp.RawArray("b", _slot_bytes())
                       for _ in range(nslots)]
        self._free_slots = list(range(nslots))
        self._task_q = mp.Queue()
        self._result_q = mp.Queue()
        # None selects the built-in collation in the worker; a pickled
        # reference to the default fn would place batches in the child
        fn = loader._batchify_fn if loader._custom_batchify else None
        for _ in range(loader._num_workers):
            p = mp.Process(
                target=_shm_worker.worker_loop,
                args=(loader._dataset, fn, self._slots, self._task_q,
                      self._result_q, _HostScope()),
                daemon=True)
            p.start()
            self._procs.append(p)

    def _push_next(self):
        if self._closed:
            return
        if self._pool is None and not self._free_slots:
            return  # every ring slot is in flight
        batch = next(self._batches, None)
        if batch is None:
            return
        if self._pool is not None:
            fut = self._pool.submit(self._worker, batch, self._sent_idx)
            self._data_buffer[self._sent_idx] = ("future", fut, batch)
        else:
            slot = self._free_slots.pop()
            self._task_q.put((self._sent_idx, slot, list(batch)))
        self._sent_idx += 1

    def _recv_until(self, idx):
        """Drain the result queue until batch `idx` has arrived.

        Slots are copied out and recycled at *receive* time, not delivery
        time, so an out-of-order fast batch never pins a slot while a
        slow one is pending."""
        while idx not in self._data_buffer:
            try:
                msg = self._result_q.get(timeout=self._data_timeout)
            except _queue.Empty:
                alive = [p.pid for p in self._procs if p.is_alive()]
                self.close(wait=False)
                self._note_timeout(idx)
                raise DataLoaderWorkerError(
                    f"DataLoader worker result for batch {idx} not "
                    f"received within MXTPU_DATA_TIMEOUT="
                    f"{self._data_timeout}s (hung worker? live worker "
                    f"pids: {alive})")
            tag, bidx, slot, payload, is_list = msg
            if tag == "shm":
                out = _shm_worker.read_slot(self._slots[slot], payload,
                                            is_list)
                self._data_buffer[bidx] = ("data", out, None)
            elif tag == "pickle":
                self._data_buffer[bidx] = ("data", payload, None)
            else:  # "error"
                self._data_buffer[bidx] = ("error", payload, None)
            if slot is not None:
                self._free_slots.append(slot)
                self._push_next()

    # -- iteration -------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._rcvd_idx == self._sent_idx or self._closed:
            self.close()
            raise StopIteration
        idx = self._rcvd_idx
        if self._pool is not None:
            kind, fut, samples = self._data_buffer.pop(idx)
            self._rcvd_idx += 1
            self._push_next()
            try:
                return fut.result(timeout=self._data_timeout)
            except _FutTimeout as err:
                self.close(wait=False)
                self._note_timeout(idx)
                raise DataLoaderWorkerError(
                    f"DataLoader worker thread hung on batch {idx} "
                    f"(sample indices {list(samples)}): no result "
                    f"within MXTPU_DATA_TIMEOUT="
                    f"{self._data_timeout}s") from err
            except Exception as err:
                self.close()
                raise DataLoaderWorkerError(
                    f"DataLoader worker failed on batch {idx} (sample "
                    f"indices {list(samples)}): {err!r}") from err
        self._recv_until(idx)
        kind, out, _ = self._data_buffer.pop(idx)
        self._rcvd_idx += 1
        if kind == "error":
            exc_repr, tb, samples = out
            self.close()
            raise DataLoaderWorkerError(
                f"DataLoader worker failed on batch {idx} (sample "
                f"indices {samples}): {exc_repr}\n"
                f"--- worker traceback ---\n{tb}")
        if isinstance(out, _np.ndarray) or (
                isinstance(out, list)
                and out and isinstance(out[0], _np.ndarray)):
            # workers transport host numpy; the parent places it
            return _place_host(out, self._mode, self._ctx)
        return out

    # -- cleanup ---------------------------------------------------------------

    @staticmethod
    def _note_timeout(idx):
        _telemetry.event("data_worker_timeout", batch=int(idx))

    def close(self, wait=True):
        """Cancel pending work and release threads/processes/queues.
        ``wait=False`` (the hung-worker watchdog path) skips blocking
        joins — waiting on the very worker that just timed out would
        turn the watchdog into the hang it exists to break."""
        if self._closed:
            return
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=wait, cancel_futures=True)
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5 if wait else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1)
        if self._procs:
            for q in (self._task_q, self._result_q):
                q.cancel_join_thread()
                q.close()
        self._data_buffer.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _ResumableIter:
    """Delivery-time sample accounting + quarantine-honoring replay.

    Wraps the transport iterator (same-process generator or
    `_MultiWorkerIter`) of a seeded DataLoader.  The batch *plan* — the
    submission-ordered stream of index batches — is generated lazily
    from the `ResumableSampler` and tagged with each batch's global
    ordinal; quarantined ordinals are dropped from the plan (never
    fetched).  The shared `DataPipelineState` advances only when a batch
    is actually DELIVERED here, with any preceding quarantine skips
    accounted — and announced via one ``batch_quarantined`` telemetry
    event each — in exact delivery order.

    A wrapper that prefetches FURTHER downstream (`DevicePrefetcher`)
    calls ``defer_accounting()``: each delivery then queues a commit
    *token* instead of applying it, and the wrapper commits the token
    when the batch finally reaches ITS consumer — so the state is
    delivery-exact at the outermost layer, and tokens for batches a
    teardown discards are simply never committed.
    """

    def __init__(self, loader, mode, ctx):
        self._loader = loader
        self._state = loader._state
        # submission-ordered ("skip"|"deliver", ordinal, n_samples)
        # events, drained in delivery order by _drain()
        self._events = collections.deque()
        self._inner = loader._raw_iter(self._plan(), mode, ctx)
        self._done = False
        self._deferred = False
        self._tokens = collections.deque()

    def _plan(self):
        st = self._state
        epoch, ordinal = st.epoch, st.batch_idx
        for batch in self._loader._batch_sampler:
            quarantined = st.is_quarantined(epoch, ordinal)
            self._events.append(
                ("skip" if quarantined else "deliver", ordinal,
                 len(batch)))
            ordinal += 1
            if not quarantined:
                yield batch

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        try:
            out = next(self._inner)
        except StopIteration:
            self._finish_epoch()
            raise
        self._settle(self._drain(stop_after_deliver=True))
        return out

    def _drain(self, stop_after_deliver):
        token = []
        while self._events:
            ev = self._events.popleft()
            token.append(ev)
            if stop_after_deliver and ev[0] == "deliver":
                break
        return token

    def _settle(self, token):
        if self._deferred:
            self._tokens.append(token)
        else:
            self.commit(token)

    def _finish_epoch(self):
        # trailing events can only be quarantine skips (every deliver
        # event precedes its batch's delivery)
        token = self._drain(stop_after_deliver=False)
        token.append(("epoch_end",))
        self._settle(token)
        self._done = True

    # -- deferred accounting (DevicePrefetcher) --------------------------------

    def defer_accounting(self):
        """Queue commit tokens instead of applying them: the caller is
        prefetching ahead of the real consumer and will ``commit`` each
        token at downstream delivery time."""
        self._deferred = True
        return self

    def take_token(self):
        return self._tokens.popleft() if self._tokens else None

    def commit(self, token):
        st = self._state
        for ev in token or ():
            if ev[0] == "skip":
                _, ordinal, n = ev
                st.skip(n)
                _telemetry.event("batch_quarantined", epoch=st.epoch,
                                 batch=int(ordinal), samples=int(n))
            elif ev[0] == "deliver":
                st.advance(ev[2])
            else:   # "epoch_end"
                st.next_epoch()

    def close(self):
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
