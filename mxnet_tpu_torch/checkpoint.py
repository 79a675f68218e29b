"""Checkpointing: async, two-phase-committed, CRC-checked snapshots.

Counterpart of ``mxnet_tpu/checkpoint.py``.  :class:`AsyncCheckpointer`
is the engine:

- async saves: ``save()`` orders a copy-on-snapshot of the state before
  it returns and a writer thread pickles, writes and fsyncs it.  A leaf on
  the card is copied into pinned host memory on a side stream, which
  first waits on the current stream; the current stream then waits on the
  copy's event, so the next step (a CUDA graph replay that rewrites the
  same buffers in place) runs after the copy, and the writer waits on the
  same event before it pickles.  At most one save is outstanding, and a
  writer's error is raised by the next ``save()`` or ``wait()``.
- two-phase commit: each rank writes its shard
  (``MXTCKPT1 | crc32 | length | pickle``) and its ``rank_*.json``,
  barriers, then rank 0 renames ``MANIFEST.json`` into place, the one
  commit point.  A crash at any instant leaves the previous or the new
  checkpoint restorable; orphans are collected on the next save.
- restore: the manifest's skeleton rebuilds the tree; a ``template``
  whose leaves are ``torch.device`` objects (or tensors) places the leaves.

The on-disk layout, the manifest and the shard framing are the JAX
package's, so a checkpoint either package writes restores in the other.
A bf16 leaf (numpy has no bf16) is stored as its 16-bit words, a
``uint16`` array, with ``{"__leaf__": i, "__dtype__": "bfloat16"}`` in
the skeleton; the port restores it as a bf16 tensor, bitwise, and the
JAX package, which reads ``__leaf__`` first, as the uint16 words.  A
JAX-written ``ml_dtypes.bfloat16`` leaf restores as a bf16 tensor too.

:class:`PeerSnapshotStore` keeps snapshots in RAM for the elastic gang
and serves them over TCP in the JAX package's ``MXTPSNP1`` frames.  What
goes into its pickles is numpy and builtins only: a bf16 leaf travels as
``{"__mxt_bf16__": <uint16 words>}`` and comes back a bf16 tensor, and a
numpy-only snapshot is byte for byte the JAX package's, so either
package's store serves the other's.  ``AsyncCheckpointer.attach_peers``
adds the peer replica to the writer: a save's shard, and a gang snapshot
(``push_peers``), are copied off the card by the same pinned
copy-on-snapshot as a save, and the writer thread pickles, holds and
sends them.

``trainer_state`` / ``load_trainer_state`` take a ``gluon.Trainer`` or a
``parallel.ShardedTrainer``; ``PreemptionHandler`` checkpoints on
SIGTERM; ``make_checkpointer`` picks an engine.  Fault sites:
``crash_during_save``, ``crash_before_manifest``, ``corrupt_shard:K``.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import shutil
import signal
import socket
import struct
import sys
import threading
import time
import zlib

import torch

from . import integrity
from . import resilience
from . import telemetry
from .base import MXNetError
from .resilience import CheckpointCorrupt


# -- pytree plumbing (dict / list / tuple / scalars / arrays) ------------------

_MANIFEST_MAGIC = "MXTMANIFEST1"
_MANIFEST_VERSION = 1
_SHARD_MAGIC = b"MXTCKPT1"          # same framing as LocalCheckpointer
_SCALARS = (int, float, bool, str, bytes, type(None))


def _is_array(v):
    return hasattr(v, "__array__") or isinstance(v, torch.Tensor)


def _host_copy(t):
    """A CPU tensor's words as a new numpy array (bf16 as uint16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("uint16").copy()
    return t.numpy().copy()


def _np_dtype_name(t):
    """The numpy dtype a tensor's host copy has (bf16: its uint16 words)."""
    if t.dtype == torch.bfloat16:
        return "uint16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def snapshot_to_host(state):
    """Deep copy-on-snapshot: every array leaf becomes a host copy, a
    numpy array (a bf16 tensor, which numpy cannot hold, a CPU bf16
    tensor).  A tensor on the card is read back after the work queued
    before this call."""
    import numpy as np


    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            out = [conv(x) for x in v]
            return out if isinstance(v, list) else tuple(out)
        if isinstance(v, np.ndarray):
            return np.array(v, copy=True)
        v = getattr(v, "_data", v)
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                return v.cpu() if v.is_cuda else v.clone()
            return v.cpu().numpy() if v.is_cuda else v.numpy().copy()
        if _is_array(v):
            return np.asarray(v)
        return v

    return conv(state)


def _flatten(state):
    """Flatten a pytree into (leaves, skeleton): array leaves become
    ``{"__leaf__": i}`` markers (a bf16 tensor's with ``"__dtype__":
    "bfloat16"``), scalars inline, containers stay JSON, so the skeleton
    travels inside MANIFEST.json and restore needs no pickled
    structure."""
    leaves = []

    def walk(v):
        if isinstance(v, dict):
            for k in v:
                if not isinstance(k, str):
                    raise MXNetError(
                        f"checkpoint state dict keys must be str, got "
                        f"{type(k).__name__} ({k!r})")
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return {"__tuple__": [walk(x) for x in v]}
        if isinstance(v, list):
            return [walk(x) for x in v]
        v = getattr(v, "_data", v) if not isinstance(v, _SCALARS) else v
        if isinstance(v, torch.Tensor):
            leaves.append(v)
            node = {"__leaf__": len(leaves) - 1}
            if v.dtype == torch.bfloat16:
                node["__dtype__"] = "bfloat16"
            return node
        if _is_array(v):
            leaves.append(v)
            return {"__leaf__": len(leaves) - 1}
        if isinstance(v, _SCALARS):
            return {"__scalar__": v}
        raise MXNetError(
            f"checkpoint state contains an unserializable leaf of type "
            f"{type(v).__name__}")

    return leaves, walk(state)


def _restored_leaf(arr, dtype=None):
    """A stored leaf as the port restores it: bf16 words (a
    ``__dtype__`` marker, or a JAX-written ``ml_dtypes`` bfloat16 array)
    become a bf16 tensor, anything else stays a numpy array."""
    import numpy as np

    if dtype == "bfloat16" or getattr(getattr(arr, "dtype", None), "name",
                                      None) == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return arr


def _unflatten(skeleton, leaves):
    """Rebuild the pytree from a manifest skeleton + leaf mapping."""
    def walk(s):
        if isinstance(s, dict):
            if "__leaf__" in s:
                return _restored_leaf(leaves[s["__leaf__"]],
                                      s.get("__dtype__"))
            if "__tuple__" in s:
                return tuple(walk(x) for x in s["__tuple__"])
            if "__scalar__" in s:
                return s["__scalar__"]
            return {k: walk(x) for k, x in s.items()}
        if isinstance(s, list):
            return [walk(x) for x in s]
        raise CheckpointCorrupt(f"manifest skeleton node {s!r} invalid")

    return walk(skeleton)


def _write_shard(path, payload_by_leaf):
    """Write one rank's shard — ``MXTCKPT1 | crc32 | length | pickle`` —
    durably (fsync file, then the directory).  Returns (crc, size).

    The ``crash_during_save`` fault site kills the process after HALF
    the payload hits disk: the torn file is exactly what a real power
    cut leaves, and the commit protocol must shrug it off.
    """
    blob = pickle.dumps(payload_by_leaf, protocol=4)
    crc = zlib.crc32(blob) & 0xffffffff
    header = _SHARD_MAGIC + struct.pack("<IQ", crc, len(blob))
    tmp = path + ".tmp"
    half = len(blob) // 2
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(blob[:half])
        f.flush()   # the torn-write point: half the payload is on disk
        resilience.maybe_crash("crash_during_save")
        f.write(blob[half:])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    resilience.fsync_dir(os.path.dirname(path))
    return crc, len(blob)


def _read_shard(path, crc=None, size=None):
    """Read + CRC-validate one shard file (io_retry: flaky-NFS class)."""
    def read():
        with open(path, "rb") as f:
            return f.read()

    blob = resilience.io_retry(read, description=f"read {path}")
    hdr = len(_SHARD_MAGIC) + 12
    if len(blob) < hdr or not blob.startswith(_SHARD_MAGIC):
        raise CheckpointCorrupt(f"{path}: bad shard magic")
    fcrc, flen = struct.unpack("<IQ", blob[len(_SHARD_MAGIC):hdr])
    payload = blob[hdr:]
    if len(payload) != flen or (size is not None and flen != size):
        raise CheckpointCorrupt(
            f"{path}: truncated (want {size if size is not None else flen}"
            f" payload bytes, have {len(payload)})")
    actual = zlib.crc32(payload) & 0xffffffff
    if actual != fcrc or (crc is not None and actual != crc):
        raise CheckpointCorrupt(f"{path}: checksum mismatch")
    return pickle.loads(payload)


class ShardedCheckpointer:
    """Save/restore sharded train state (params + optimizer + step), the
    JAX package's orbax-backed surface (``save``, ``restore(step,
    template)``, ``latest_step``, ``all_steps``, ``wait``, ``close``).
    Orbax is JAX's: here the native :class:`AsyncCheckpointer` holds the
    state, in its own layout."""

    def __init__(self, directory, max_to_keep=3, async_save=True):
        self._ck = AsyncCheckpointer(directory, max_to_keep=max_to_keep,
                                     async_save=async_save)
        self._dir = self._ck._dir

    def save(self, step, state):
        """state: a pytree of tensors and arrays."""
        self._ck.save(step, state)
        return step

    def restore(self, step=None, template=None):
        """Restore the given (or latest) step; ``template`` places the
        leaves (see ``AsyncCheckpointer.restore``)."""
        return self._ck.restore(step, template=template)

    def latest_step(self):
        return self._ck.latest_step()

    def all_steps(self):
        """All retained checkpoint steps, ascending."""
        return self._ck.all_steps()

    def wait(self):
        """Block until async saves finish."""
        self._ck.wait()

    def close(self):
        self._ck.close()


# -- native async multi-host engine --------------------------------------------

def _dist_info():
    """(rank, world_size) of the current process: the process group's,
    (0, 1) without one."""
    from . import distributed

    return distributed.rank(), distributed.num_workers()


class AsyncCheckpointer:
    """Native async snapshot-and-commit checkpoints, single- or multi-host.

    Layout (one directory per step, shared storage across hosts)::

        <dir>/step_0000000120/shard_00000.mxtckpt   rank 0's leaves
                              shard_00001.mxtckpt   rank 1's leaves
                              rank_00000.json       per-rank manifest entry
                              rank_00001.json
                              MANIFEST.json         THE commit point

    Leaves of the flattened state pytree are partitioned round-robin
    across ranks (``leaf_index % world_size``); each rank host-copies
    and writes only its own slice, so snapshot cost and write bandwidth
    scale down with the fleet.  ``MANIFEST.json`` (magic, world size,
    step, skeleton, per-shard CRCs/sizes) is written by rank 0 with
    tmp-file + ``os.replace`` + directory fsync AFTER a cross-host
    barrier confirms every shard is durable: a crash at any instant
    leaves either the previous or the new checkpoint fully restorable,
    never a torn one.  Restore reassembles from the manifest and — via a
    ``template`` pytree of shardings — re-lays the state onto any world
    size or mesh.

    Same save/restore/latest_step/all_steps/wait surface as
    `resilience.LocalCheckpointer`, so `resilience.run_resilient`,
    `DivergenceMonitor` rollback, and `PreemptionHandler` compose with
    it unchanged.
    """

    def __init__(self, directory, max_to_keep=3, async_save=None,
                 rank=None, world_size=None, logger=None,
                 barrier_fn=None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        if async_save is None:
            async_save = os.environ.get(
                "MXTPU_ASYNC_CKPT", "1").lower() not in ("0", "false",
                                                         "off")
        self.async_save = bool(async_save)
        if rank is None or world_size is None:
            r, w = _dist_info()
            # a cross-host barrier only exists when the world size came
            # from the real distributed runtime (tests fake N ranks in
            # one process by passing rank=/world_size= explicitly)
            self._use_barrier = world_size is None and w > 1
            rank = r if rank is None else rank
            world_size = w if world_size is None else world_size
        else:
            self._use_barrier = False
        self.rank = int(rank)
        self.world_size = int(world_size)
        # explicit rank/world gangs (no process group) can
        # still sync the two-phase commit through a caller-supplied
        # barrier — ElasticGang.barrier, which stays death-responsive
        self._barrier_fn = barrier_fn
        self._logger = logger
        self._thread = None
        self._pending_step = None
        self._error = None
        self._lock = threading.Lock()
        # the card's leaves: a side stream for their copies and pinned
        # host buffers reused from save to save (one save is outstanding)
        self._copy_stream = None
        self._pinned = {}
        # epoch fencing (attach_gang): stamp the gang epoch into shard
        # votes and MANIFEST.json, and re-validate it right before the
        # atomic manifest rename
        self._gang_epoch_fn = None
        self._gang_fence_fn = None
        # peer RAM replication (attach_peers)
        self._peer_store = None
        self._peer_every = 0
        self.peer_stats = {}        # the last push_peers' host times, ms

    # -- paths -----------------------------------------------------------------

    def _step_dir(self, step):
        return os.path.join(self._dir, f"step_{int(step):010d}")

    @staticmethod
    def _shard_name(rank):
        return f"shard_{rank:05d}.mxtckpt"

    @staticmethod
    def _entry_name(rank):
        return f"rank_{rank:05d}.json"

    # -- save ------------------------------------------------------------------

    def save(self, step, state, data_state=None):
        """Snapshot ``state`` to host and return; serialization, fsync,
        and the cross-host commit run on a background writer (unless
        ``async_save=False``).  At most ONE save is outstanding: a new
        ``save()`` first blocks on the previous commit (backpressure),
        and any error the writer hit is raised here or in ``wait()``.

        ``data_state`` (optional): a JSON-serializable input-pipeline
        ``state_dict()`` (see gluon/data/state.py).  Captured here,
        synchronously — the pipeline keeps advancing while the writer
        runs — and stamped into MANIFEST.json with a CRC so restore
        resumes at the exact sample offset."""
        # everything before save() returns — backpressure join, host
        # snapshot, sync commit — stalls the train loop; the async
        # writer's work after that does not
        t0 = time.perf_counter()
        self._join(raise_error=True)
        leaves, skeleton = _flatten(state)
        mine, metas, event = self._snapshot_local(leaves)
        ds = None if data_state is None else copy.deepcopy(data_state)
        if not self.async_save:
            with resilience.guard_checkpoint(f"ckpt_save:{step}"):
                if event is not None:
                    event.synchronize()
                self._commit(step, mine, metas, skeleton, ds)
            self._count_stall(t0)
            return step
        self._pending_step = step
        self._thread = threading.Thread(
            target=self._writer,
            args=(step, mine, metas, skeleton, ds, event),
            name=f"ckpt_writer:{step}", daemon=True)
        self._thread.start()
        self._count_stall(t0)
        return step

    @staticmethod
    def _count_stall(t0):
        telemetry.count("ckpt.stall_us",
                        int((time.perf_counter() - t0) * 1e6))
        telemetry.count("ckpt.saves")

    def _snapshot_local(self, leaves, whole=False):
        """Order THIS rank's leaves' host copies; record every leaf's
        meta.  Returns (mine, metas, event): ``mine`` maps a leaf index to
        its numpy host array, valid once ``event`` (None when nothing was
        on the card) has completed.

        The copies are ordered here, before ``save()`` returns: the next
        step rewrites the card's buffers in place, and numpy state may be
        mutated by the trainer, so the writer never reads the originals.
        A card leaf goes into a pinned host buffer (reused from save to
        save: at most one save is outstanding) on a side stream."""
        import numpy as np

        mine, metas, card = {}, {}, []
        for i, v in enumerate(leaves):
            arr = getattr(v, "_data", v)
            is_t = isinstance(arr, torch.Tensor)
            metas[i] = {"shape": list(arr.shape) if is_t
                        else list(np.shape(arr)),
                        "dtype": _np_dtype_name(arr) if is_t
                        else str(getattr(arr, "dtype", "object")),
                        "shard": i % self.world_size}
            if not whole and i % self.world_size != self.rank:
                continue
            if is_t and arr.is_cuda:
                card.append((i, arr.detach()))
            elif is_t:
                mine[i] = _host_copy(arr)
            else:
                mine[i] = np.array(arr, copy=True) \
                    if isinstance(arr, np.ndarray) else np.asarray(arr)
        if not card:
            return mine, metas, None
        dev = card[0][1].device
        if self._copy_stream is None or self._copy_stream.device != dev:
            self._copy_stream = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        self._copy_stream.wait_stream(main)
        with torch.cuda.stream(self._copy_stream):
            for i, t in card:
                src = t.reshape(-1)
                if src.dtype == torch.bfloat16:
                    src = src.view(torch.int16)
                buf = self._pinned.get(i)
                if buf is None or buf.dtype != src.dtype or \
                        buf.numel() != src.numel():
                    buf = self._pinned[i] = torch.empty(
                        src.numel(), dtype=src.dtype, pin_memory=True)
                buf.copy_(src, non_blocking=True)
                host = buf.numpy().reshape(tuple(t.shape))
                mine[i] = host.view(np.uint16) \
                    if t.dtype == torch.bfloat16 else host
        event = torch.cuda.Event()
        event.record(self._copy_stream)
        main.wait_event(event)
        return mine, metas, event

    def _writer(self, step, mine, metas, skeleton, data_state=None,
                event=None):
        timeout = os.environ.get("MXTPU_CKPT_TIMEOUT")
        # dump-only watchdog: a hung filesystem in the WRITER thread
        # surfaces as stack dumps now and an error at the train thread's
        # next save()/wait() (which guard_checkpoint supervises)
        wd = resilience.Watchdog(
            float(timeout), name=f"async_ckpt:{step}",
            action="none").start() if timeout else None
        try:
            if event is not None:
                event.synchronize()     # the pinned copies have landed
            self._commit(step, mine, metas, skeleton, data_state)
        except BaseException as e:          # noqa: BLE001
            with self._lock:
                self._error = e
        finally:
            if wd is not None:
                wd.cancel()

    def _commit(self, step, mine, metas, skeleton, data_state=None):
        """Phase 1: durable local shard + rank entry.  Barrier.
        Phase 2: rank 0 atomically renames MANIFEST.json."""
        sdir = self._step_dir(step)
        if self.rank == 0:
            self._gc_orphans(keep_step=step)
        os.makedirs(sdir, exist_ok=True)
        crc, size = _write_shard(
            os.path.join(sdir, self._shard_name(self.rank)), mine)
        entry = {"rank": self.rank, "file": self._shard_name(self.rank),
                 "crc": crc, "size": size,
                 "leaves": sorted(mine),
                 "leaf_meta": {str(i): metas[i] for i in metas}}
        if self._gang_epoch_fn is not None:
            # the shard vote carries the epoch it was written under —
            # rank 0's fence check and post-hoc audits read it back
            entry["gang_epoch"] = int(self._gang_epoch_fn())
        epath = os.path.join(sdir, self._entry_name(self.rank))
        with open(epath + ".tmp", "w") as f:
            json.dump(entry, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(epath + ".tmp", epath)
        resilience.fsync_dir(sdir)
        if self._peer_store is not None and self._peer_every and \
                int(step) % self._peer_every == 0:
            # the peer replica rides the writer: the host copy exists, so
            # the extra cost is one pickle and one send
            buddy = (self.rank + 1) % self.world_size
            payload = mine if data_state is None else \
                _peer_wrap(mine, data_state)
            blob = self._peer_store.pack(payload)
            self._peer_store.hold_blob(self.rank, step, blob)
            if buddy != self.rank:
                self._peer_store.send_blob(buddy, step, blob)
        self._barrier(f"ckpt_shards_{step}")
        resilience.maybe_crash("crash_before_manifest")
        if self.rank == 0:
            self._write_manifest(step, sdir, skeleton, data_state)
            self._corrupt_shard_fault(sdir)
        self._barrier(f"ckpt_commit_{step}")
        if self.rank == 0:
            self._prune()
        self._log(f"checkpoint step {step} committed "
                  f"(rank {self.rank}/{self.world_size})")
        telemetry.count("ckpt.commits")
        telemetry.event("ckpt_commit", step=int(step), rank=self.rank)

    def _barrier(self, name):
        if self._barrier_fn is not None:
            self._barrier_fn(name)
        elif self._use_barrier:
            from . import distributed

            distributed.barrier(name)

    def attach_peers(self, store, every=None):
        """Enable peer RAM replication: every ``every`` saves (default
        ``MXTPU_PEER_SNAP_EVERY``, 10) the writer ships this rank's CRC'd
        shard dict to buddy ``(rank+1) % world`` through ``store`` (a
        :class:`PeerSnapshotStore`) and keeps its own RAM copy, the fast
        elastic-recovery source that spares the disk manifest.  An
        ``ElasticGang`` built on this checkpointer and store takes its
        peer snapshots through :meth:`push_peers`."""
        self._peer_store = store
        self._peer_every = int(
            os.environ.get("MXTPU_PEER_SNAP_EVERY", 10)
            if every is None else every)
        return self

    def push_peers(self, step, state, buddy, epoch=0, after=None):
        """A gang snapshot of the whole ``state`` into RAM: held here and
        sent to ``buddy``'s store, then ``after()`` (the gang's advert).
        Like a save it returns once the copy is ordered: leaves on the
        card go into the pinned buffers on the side stream, and the
        writer thread waits for them, pickles, holds and sends.  It
        shares the save's backpressure: an outstanding save or push is
        joined first, and its error raised here."""
        t0 = time.perf_counter()
        self._join(raise_error=True)
        t1 = time.perf_counter()
        leaves, skeleton = _flatten(state)
        mine, _metas, event = self._snapshot_local(leaves, whole=True)
        self._pending_step = step
        self._thread = threading.Thread(
            target=self._peer_writer,
            args=(step, skeleton, mine, event, buddy, int(epoch), after),
            name=f"peer_snap:{step}", daemon=True)
        self._thread.start()
        t2 = time.perf_counter()
        self.peer_stats = {"join_ms": (t1 - t0) * 1e3,
                           "call_ms": (t2 - t1) * 1e3}

    def _peer_writer(self, step, skeleton, mine, event, buddy, epoch,
                     after):
        try:
            if event is not None:
                event.synchronize()     # the pinned copies have landed
            store = self._peer_store
            blob = store.pack(_wire_from_flat(skeleton, mine))
            store.hold_blob(store.rank, step, blob, epoch)
            if buddy != store.rank:
                store.send_blob(buddy, step, blob, epoch)
            if after is not None:
                after()
        except BaseException as e:          # noqa: BLE001
            with self._lock:
                self._error = e

    def attach_gang(self, epoch_fn, fence_fn=None):
        """Enable epoch fencing on the durable commit (schema v8).

        ``epoch_fn()`` returns the gang epoch THIS rank believes it is
        in — stamped into its rank entry and into MANIFEST.json.
        ``fence_fn()`` returns the highest COMMITTED epoch (the KV
        fence); rank 0 re-validates its own epoch against it
        immediately before the atomic manifest rename and ABORTS the
        commit when a newer epoch has committed meanwhile — a paused
        or partitioned rank 0 must not publish a stale restore point
        (``ckpt_fenced`` event, no orphan manifest, the previous
        manifest stays the restore point).  An unreachable KV fails
        closed: no fence answer, no rename."""
        self._gang_epoch_fn = epoch_fn
        self._gang_fence_fn = fence_fn
        return self

    def _write_manifest(self, step, sdir, skeleton, data_state=None):
        shards, leaf_meta = [], {}
        for r in range(self.world_size):
            epath = os.path.join(sdir, self._entry_name(r))

            def read(p=epath):
                with open(p) as f:
                    return json.load(f)

            try:
                entry = resilience.io_retry(
                    read, description=f"read {epath}")
            except FileNotFoundError:
                raise MXNetError(
                    f"checkpoint step {step}: rank {r} wrote no manifest "
                    f"entry after the shard barrier — commit aborted "
                    f"(previous checkpoint remains valid)") from None
            shards.append({"file": entry["file"], "rank": entry["rank"],
                           "crc": entry["crc"], "size": entry["size"],
                           "leaves": entry["leaves"]})
            leaf_meta.update(entry["leaf_meta"])
        manifest = {"magic": _MANIFEST_MAGIC,
                    "version": _MANIFEST_VERSION,
                    "step": int(step),
                    "world_size": self.world_size,
                    "skeleton": skeleton,
                    "leaf_meta": leaf_meta,
                    "shards": shards}
        stamp = integrity.manifest_stamp()
        if stamp is not None:
            # tier-3 provenance: the attestation-ledger head at commit
            # time — restore audits it back to the chain (optional key,
            # same manifest version: old readers ignore it)
            manifest["integrity"] = stamp
        if data_state is not None:
            # input-pipeline resume point (optional key, same manifest
            # version: manifests without it restore exactly as before)
            manifest["data_state"] = resilience.data_state_stamp(
                data_state)
        if self._gang_epoch_fn is not None:
            manifest["gang_epoch"] = int(self._gang_epoch_fn())
        mpath = os.path.join(sdir, "MANIFEST.json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # fence re-validation IMMEDIATELY before the atomic rename: all
        # the durable work above is harmless (a .tmp is invisible to
        # restore); the rename is the one operation that publishes a
        # restore point, so it is the one operation a stale rank 0 —
        # resumed from a pause, or the minority side of a partition —
        # must never perform
        self._check_manifest_fence(step, manifest.get("gang_epoch"),
                                   mpath)
        os.replace(mpath + ".tmp", mpath)   # THE commit point
        resilience.fsync_dir(sdir)
        resilience.fsync_dir(self._dir)

    def _check_manifest_fence(self, step, epoch, mpath):
        if self._gang_fence_fn is None or epoch is None:
            return
        try:
            committed = int(self._gang_fence_fn())
            if committed <= int(epoch):
                return
            reason = f"committed gang epoch {committed} > " \
                     f"this rank's epoch {epoch}"
        except Exception as e:      # noqa: BLE001 — fail CLOSED: a
            committed = -1          # rank that cannot read the fence
            reason = f"gang KV unreachable ({e})"   # must not publish
        try:
            os.unlink(mpath + ".tmp")
        except OSError:
            pass
        telemetry.count("ckpt.fenced_aborts")
        telemetry.event("ckpt_fenced", step=int(step), rank=self.rank,
                        epoch=int(epoch), committed=committed,
                        reason=reason[:200])
        raise MXNetError(
            f"checkpoint step {step}: manifest commit FENCED — "
            f"{reason}; the previous manifest remains the restore "
            f"point")

    def _corrupt_shard_fault(self, sdir):
        """``corrupt_shard:K``: bit-rot shard K of the checkpoint that
        just committed (tests the CRC fail-closed path + fallback)."""
        k = resilience.fault_arg("corrupt_shard")
        if k is None or not resilience.consume_charges(
                "corrupt_shard", on_last=False):
            return
        path = os.path.join(sdir, self._shard_name(int(k)))
        with open(path, "r+b") as f:
            f.seek(-4, os.SEEK_END)
            f.write(b"\xde\xad\xbe\xef")

    def _gc_orphans(self, keep_step):
        """Remove uncommitted step dirs (crash leftovers) and stray tmp
        files.  A dir is an orphan iff it has no MANIFEST.json — i.e. a
        crash happened between shard writes and the commit rename."""
        for name in os.listdir(self._dir):
            path = os.path.join(self._dir, name)
            if name.endswith(".tmp"):
                _remove_quiet(path)
                continue
            if not name.startswith("step_") or not os.path.isdir(path):
                continue
            try:
                s = int(name[5:])
            except ValueError:
                continue
            if s != keep_step and \
                    not os.path.exists(os.path.join(path,
                                                    "MANIFEST.json")):
                self._log(f"garbage-collecting orphan checkpoint {name} "
                          f"(no manifest — crashed save)")
                shutil.rmtree(path, ignore_errors=True)

    def _prune(self):
        if not self.max_to_keep:
            return
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- wait / error propagation ----------------------------------------------

    def _join(self, raise_error):
        t = self._thread
        if t is not None and t.is_alive():
            with resilience.guard_checkpoint(
                    f"ckpt_wait:{self._pending_step}"):
                t.join()
        self._thread = None
        self._pending_step = None
        if raise_error:
            with self._lock:
                err, self._error = self._error, None
            if err is not None:
                raise err

    def wait(self):
        """Block until the outstanding save commits; re-raise any error
        the background writer hit."""
        self._join(raise_error=True)

    def in_flight(self):
        """True while a background save has not yet committed."""
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def pending_step(self):
        return self._pending_step if self.in_flight() else None

    # -- restore ---------------------------------------------------------------

    def _manifest(self, step):
        mpath = os.path.join(self._step_dir(step), "MANIFEST.json")

        def read():
            with open(mpath) as f:
                return json.load(f)

        try:
            m = resilience.io_retry(read, description=f"read {mpath}")
        except FileNotFoundError:
            raise CheckpointCorrupt(
                f"{mpath}: no manifest (uncommitted checkpoint)") \
                from None
        except ValueError as e:
            raise CheckpointCorrupt(f"{mpath}: unparseable ({e})") from e
        if not isinstance(m, dict) or m.get("magic") != _MANIFEST_MAGIC:
            raise CheckpointCorrupt(f"{mpath}: bad manifest magic")
        if m.get("version") != _MANIFEST_VERSION:
            raise CheckpointCorrupt(
                f"{mpath}: manifest version {m.get('version')} "
                f"(this build reads {_MANIFEST_VERSION})")
        if len(m.get("shards", [])) != m.get("world_size"):
            raise CheckpointCorrupt(
                f"{mpath}: {len(m.get('shards', []))} shard entries for "
                f"world size {m.get('world_size')}")
        return m

    def restore(self, step=None, template=None):
        """Reassemble the checkpoint from its manifest.

        Without ``template``: returns the host pytree (numpy arrays, bf16
        leaves as bf16 tensors), world-size independent, except that a
        running multi-process job whose world size differs from the
        writer's must pass a template.  With ``template``, a matching
        pytree whose array positions hold ``torch.device`` objects or tensors,
        every leaf is checked (shape, dtype) and placed there.
        """
        # drain (but don't fail on) an in-flight save: its error stays
        # queued for the next save()/wait(), while restore proceeds from
        # the newest COMMITTED checkpoint
        self._join(raise_error=False)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise MXNetError(f"no checkpoints under {self._dir}")
        with resilience.guard_checkpoint(f"ckpt_restore:{step}"):
            m = self._manifest(step)
            ok, why = integrity.verify_provenance(m)
            if not ok:
                raise CheckpointCorrupt(
                    f"checkpoint step {step}: integrity provenance "
                    f"failed — {why}")
            if template is None and self.world_size > 1 \
                    and self._use_barrier \
                    and m["world_size"] != self.world_size:
                raise MXNetError(
                    f"checkpoint step {step} was written by "
                    f"{m['world_size']} hosts but this job runs "
                    f"{self.world_size}: pass template= (a pytree of "
                    f"shardings) to restore elastically")
            leaves = self._load_leaves(step, m)
            state = _unflatten(m["skeleton"], leaves)
        if template is not None:
            state = _apply_template(state, template)
        telemetry.count("ckpt.disk_restores")
        return state

    def _load_leaves(self, step, m):
        import numpy as np

        sdir = self._step_dir(step)
        leaves = {}
        for sh in m["shards"]:
            payload = _read_shard(os.path.join(sdir, sh["file"]),
                                  crc=sh["crc"], size=sh["size"])
            for i in sh["leaves"]:
                if i not in payload:
                    raise CheckpointCorrupt(
                        f"{sh['file']}: leaf {i} listed in manifest but "
                        f"missing from shard payload")
                leaves[i] = payload[i]
        for key, meta in m["leaf_meta"].items():
            i = int(key)
            if i not in leaves:
                raise CheckpointCorrupt(
                    f"checkpoint step {step}: leaf {i} missing from "
                    f"every shard")
            arr = leaves[i]
            if list(np.shape(arr)) != list(meta["shape"]) or \
                    str(arr.dtype) != meta["dtype"]:
                raise CheckpointCorrupt(
                    f"checkpoint step {step}: leaf {i} is "
                    f"{np.shape(arr)}/{arr.dtype}, manifest says "
                    f"{tuple(meta['shape'])}/{meta['dtype']}")
        return leaves

    def verify(self, step):
        """Re-read manifest + every shard, checksum-validated (the
        verify-after-write hook `resilience._save_verified` calls).
        Returns the validated manifest so callers (the serving reload
        gate) can audit its integrity stamp without a second read."""
        m = self._manifest(step)
        self._load_leaves(step, m)
        return m

    def data_state(self, step=None):
        """The input-pipeline ``state_dict`` stamped into ``step``'s
        manifest (latest committed step when None), or None when the
        checkpoint predates data-state stamping — restore stays backward
        compatible.  A present-but-corrupt stamp raises
        `CheckpointCorrupt` (fail closed: silently resuming at the wrong
        sample offset is the one outcome this subsystem exists to
        prevent).  When the step only exists as a peer-RAM snapshot, this
        rank's own held wrap in the attached store answers."""
        self._join(raise_error=False)
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        mpath = os.path.join(self._step_dir(step), "MANIFEST.json")
        if not os.path.exists(mpath):
            if self._peer_store is not None:
                # the step exists only as a peer-RAM snapshot (elastic
                # recovery beat the disk manifest): this rank's own wrap
                return self._peer_store.data_state_at(self.rank, step)
            return None
        m = self._manifest(step)
        return resilience.data_state_unstamp(m.get("data_state"))

    # -- listing ---------------------------------------------------------------

    def all_steps(self):
        """Committed steps only (a dir without MANIFEST.json is a crash
        orphan, invisible to resume)."""
        steps = []
        for name in os.listdir(self._dir):
            if not name.startswith("step_"):
                continue
            try:
                s = int(name[5:])
            except ValueError:
                continue
            if os.path.exists(os.path.join(self._dir, name,
                                           "MANIFEST.json")):
                steps.append(s)
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        self._join(raise_error=True)

    def _log(self, msg):
        if self._logger is not None:
            self._logger.info(msg)
        else:
            sys.stderr.write(f"[checkpoint] {msg}\n")


def latest_manifest_step(directory):
    """Newest committed step in ``directory`` (a ``step_*`` dir with
    MANIFEST.json), or None.  A cheap directory scan — the serving
    reload poller calls this every MXTPU_SERVE_RELOAD_POLL_MS without
    instantiating an AsyncCheckpointer."""
    directory = os.fspath(directory)
    best = None
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for name in names:
        if not name.startswith("step_"):
            continue
        try:
            s = int(name[5:])
        except ValueError:
            continue
        if (best is None or s > best) and os.path.exists(
                os.path.join(directory, name, "MANIFEST.json")):
            best = s
    return best


def _remove_quiet(path):
    try:
        os.remove(path)
    except OSError:
        pass


# -- peer RAM snapshots (the elastic gang's fast recovery source) -------------

#: wire magic of the peer snapshot protocol (versioned like _SHARD_MAGIC)
_PEER_MAGIC = b"MXTPSNP1"
#: request header after the magic: cmd u8, from_rank u32, step u64,
#: epoch u32, crc u32, payload_len u64
_PEER_HDR = "<BIQIIQ"
_PEER_PUT, _PEER_GET = 1, 2

_PEER_WRAP_KEY = "__mxt_peer_wrap__"
#: a bf16 leaf on the wire: its 16-bit words under this key
_BF16_KEY = "__mxt_bf16__"


def _peer_wrap(state, data_state):
    """Bundle a snapshot with its input-pipeline state for peer
    replication (a plain dict; ``_peer_unwrap`` takes bare snapshots
    too)."""
    return {_PEER_WRAP_KEY: 1, "state": state, "data_state": data_state}


def _peer_unwrap(obj):
    """(state, data_state) from a possibly-wrapped peer payload."""
    if isinstance(obj, dict) and obj.get(_PEER_WRAP_KEY) == 1:
        return obj.get("state"), obj.get("data_state")
    return obj, None


def _to_wire(state):
    """A snapshot as numpy and builtins only: tensors (on the card or the
    host) and NDArrays become numpy arrays (views of host tensors: the
    pickle that follows copies them), a bf16 one its uint16 words under
    ``_BF16_KEY``."""
    import numpy as np

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            out = [conv(x) for x in v]
            return out if isinstance(v, list) else tuple(out)
        if isinstance(v, np.ndarray):
            return v                    # the pickle copies it
        v = getattr(v, "_data", v)
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                return {_BF16_KEY: t.view(torch.int16).numpy().view(
                    "uint16")}
            return t.numpy()
        if _is_array(v):
            return np.asarray(v)
        return v

    return conv(state)


def _wire_from_flat(skeleton, leaves):
    """The wire tree of a flattened state whose leaves are host arrays
    (bf16 leaves as their uint16 words, marked in the skeleton)."""
    def walk(s):
        if isinstance(s, dict):
            if "__leaf__" in s:
                arr = leaves[s["__leaf__"]]
                return {_BF16_KEY: arr} if s.get("__dtype__") == "bfloat16" \
                    else arr
            if "__tuple__" in s:
                return tuple(walk(x) for x in s["__tuple__"])
            if "__scalar__" in s:
                return s["__scalar__"]
            return {k: walk(x) for k, x in s.items()}
        return [walk(x) for x in s]

    return walk(skeleton)


def _from_wire(obj):
    """Reverse ``_to_wire``: marked words become bf16 tensors (on the
    host), everything else stays as it came."""
    if isinstance(obj, dict):
        if len(obj) == 1 and _BF16_KEY in obj:
            return _restored_leaf(obj[_BF16_KEY], "bfloat16")
        return {k: _from_wire(x) for k, x in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_from_wire(x) for x in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


def _recv_exact(conn, n):
    """``n`` bytes from ``conn`` into one buffer (a snapshot runs to GBs:
    no concatenation)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], min(n - got, 1 << 24))
        if not k:
            raise ConnectionError("peer snapshot connection closed "
                                  "mid-frame")
        got += k
    return buf


class PeerSnapshotStore:
    """RAM-resident snapshot replicas and a small TCP shard server.

    Counterpart of the JAX package's store, with its frame: ``MXTPSNP1 |
    cmd u8 | from_rank u32 | step u64 | epoch u32 | crc32 u32 | len u64 |
    pickle``.  Each rank runs one: a daemon thread serves this rank's held
    snapshots (its own and the ones peers pushed); ``send_to`` pushes a
    snapshot into a peer's RAM, ``fetch`` pulls one out during recovery.
    Addresses are advertised on the gang KV (``addr/<rank>``).  The CRC is
    checked on both ends: a recovery source that rots in transit is worse
    than the disk manifest.

    Retention is ``keep`` steps a source rank (default 2) plus anything
    younger than ``retain_s`` (default twice the heartbeat timeout): the
    survivors keep snapshotting between a death and its confirmation, and
    the time floor keeps a common restore point alive through that
    window.  ``fence(epoch)`` drops pushes stamped with an older epoch (a
    zombie sender), acknowledged but not stored.

    The pickles hold numpy and builtins only (``_to_wire``); ``own_at``
    and ``fetch`` give bf16 leaves back as bf16 tensors on the host.
    ``stats`` holds the last pack, send and fetch times in ms.
    """

    def __init__(self, rank, kv=None, host=None, keep=2, retain_s=None):
        self.rank = int(rank)
        self.kv = kv
        self.host = host or os.environ.get("MXTPU_PEER_HOST",
                                           "127.0.0.1")
        self.keep = int(keep)
        if retain_s is None:
            retain_s = float(os.environ.get(
                "MXTPU_PEER_SNAP_RETAIN",
                2.0 * float(os.environ.get("MXTPU_HEARTBEAT_TIMEOUT",
                                           5.0))))
        self.retain_s = float(retain_s)
        self.port = None
        self.stats = {}
        self._held = {}        # from_rank -> {step: (epoch, blob, t)}
        self._fence = 0        # drop PUT frames older than this epoch
        self._lock = threading.Lock()
        self._sock = None
        self._thread = None
        self._stop = threading.Event()

    def fence(self, epoch):
        """Raise the receive fence (monotonic): PUT frames stamped with an
        older gang epoch are acknowledged but not stored."""
        with self._lock:
            self._fence = max(self._fence, int(epoch))

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        if self._sock is not None:
            return self
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, 0))
        s.listen(8)
        s.settimeout(0.2)
        self._sock = s
        self.port = s.getsockname()[1]
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._serve, name=f"peer_snap:{self.rank}",
            daemon=True)
        self._thread.start()
        if self.kv is not None:
            self.kv.put_json(f"addr/{self.rank}",
                             {"host": self.host, "port": self.port})
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- server ----------------------------------------------------------------

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                with conn:
                    conn.settimeout(60.0)
                    self._handle(conn)
            except Exception:       # noqa: BLE001 — a malformed frame
                pass                # must not kill the server thread

    def _handle(self, conn):
        hdr_len = len(_PEER_MAGIC) + struct.calcsize(_PEER_HDR)
        hdr = bytes(_recv_exact(conn, hdr_len))
        if not hdr.startswith(_PEER_MAGIC):
            raise CheckpointCorrupt("peer snapshot: bad frame magic")
        cmd, from_rank, step, epoch, crc, nbytes = struct.unpack(
            _PEER_HDR, hdr[len(_PEER_MAGIC):])
        if cmd == _PEER_PUT:
            blob = _recv_exact(conn, nbytes)
            if zlib.crc32(blob) & 0xffffffff != crc:
                raise CheckpointCorrupt(
                    f"peer snapshot from rank {from_rank} step {step}: "
                    f"checksum mismatch in transit")
            with self._lock:
                fence = self._fence
            if int(epoch) < fence:
                # a stale sender (zombie, partition minority): acknowledge
                # the frame, never store it
                telemetry.count("peer_snap.fenced_drops")
                telemetry.event("fencing_rejected", rank=self.rank,
                                sender=int(from_rank), epoch=int(epoch),
                                committed=fence, kind="peer_frame",
                                step=int(step))
                conn.sendall(b"OK")
                return
            self._store(from_rank, step, epoch, blob)
            telemetry.count("peer_snap.recvs")
            conn.sendall(b"OK")
        elif cmd == _PEER_GET:
            with self._lock:
                held = self._held.get(from_rank, {}).get(step)
            if held is None:
                conn.sendall(struct.pack("<BIQ", 0, 0, 0))
                return
            blob = held[1]
            conn.sendall(struct.pack(
                "<BIQ", 1, zlib.crc32(blob) & 0xffffffff, len(blob)))
            conn.sendall(blob)
        else:
            raise CheckpointCorrupt(f"peer snapshot: unknown cmd {cmd}")

    def _store(self, from_rank, step, epoch, blob):
        now = time.monotonic()
        with self._lock:
            d = self._held.setdefault(int(from_rank), {})
            d[int(step)] = (int(epoch), blob, now)
            while len(d) > self.keep:
                oldest = min(d)
                if now - d[oldest][2] <= self.retain_s:
                    break       # still inside the detection window
                del d[oldest]
            # advertise only this epoch's steps: a pre-reshape snapshot
            # matches the old membership, never a restore point now
            steps = sorted(s for s, (e, _, _) in d.items()
                           if e == int(epoch))
        if self.kv is not None:
            self.kv.put_json(f"held/{self.rank}/{int(from_rank)}",
                             {"steps": steps, "epoch": int(epoch)})

    # -- local holds -----------------------------------------------------------

    def pack(self, state):
        """The pickled wire form of ``state`` (numpy and builtins)."""
        t0 = time.perf_counter()
        # protocol 5 writes an array's buffer once (protocol 4 copies it
        # first); either reads with pickle.loads, so the frame is the same
        blob = pickle.dumps(_to_wire(state), protocol=5)
        self.stats["pack_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["bytes"] = len(blob)
        return blob

    def hold_blob(self, from_rank, step, blob, epoch=0):
        """Hold an already packed snapshot."""
        self._store(from_rank, step, epoch, blob)

    def hold_own(self, step, state, epoch=0):
        """Keep this rank's own snapshot in RAM (served to peers during
        their recovery, and this rank's own rollback source)."""
        self._store(self.rank, step, epoch, self.pack(state))

    def _unpack_held(self, from_rank, step):
        with self._lock:
            held = self._held.get(int(from_rank), {}).get(int(step))
        if held is None:
            return None
        return _peer_unwrap(pickle.loads(held[1]))

    def own_at(self, step):
        got = self._unpack_held(self.rank, step)
        return None if got is None else _from_wire(got[0])

    def data_state_at(self, from_rank, step):
        """The input-pipeline state riding ``from_rank``'s held snapshot
        at ``step``, or None.  Every rank stamps the same global pipeline
        state, so a survivor reads its own held wrap."""
        got = self._unpack_held(from_rank, step)
        return None if got is None else got[1]

    def held_steps(self, from_rank, epoch=None):
        with self._lock:
            d = self._held.get(int(from_rank), {})
            if epoch is None:
                return sorted(d)
            return sorted(s for s, (e, _, _) in d.items()
                          if e == int(epoch))

    def held_ranks(self):
        """Source ranks this store holds snapshots of."""
        with self._lock:
            return sorted(self._held)

    def forget_rank(self, from_rank):
        """Drop every snapshot held for a departed rank and withdraw its
        advert."""
        with self._lock:
            dropped = self._held.pop(int(from_rank), None)
        if dropped and self.kv is not None:
            try:
                self.kv.delete(f"held/{self.rank}/{int(from_rank)}")
            except Exception:   # noqa: BLE001 — advert GC is best-effort
                pass

    def prune_ranks(self, members):
        """Free the snapshots of ranks no longer in the gang (called once
        every member is past its recovery's assembly)."""
        keep = set(int(r) for r in members)
        with self._lock:
            gone = [r for r in self._held if r not in keep]
        for r in gone:
            self.forget_rank(r)

    # -- client ----------------------------------------------------------------

    def _addr_of(self, rank):
        if self.kv is None:
            return None
        return self.kv.get_json(f"addr/{rank}")

    def send_to(self, peer_rank, step, state, epoch=0, timeout=5.0):
        """Push a snapshot into ``peer_rank``'s RAM.  Best-effort: a busy
        or restarting buddy costs this snapshot its replica, never the
        training step, so it returns False instead of raising."""
        return self.send_blob(peer_rank, step, self.pack(state), epoch,
                              timeout)

    def send_blob(self, peer_rank, step, blob, epoch=0, timeout=5.0):
        """``send_to`` of an already packed snapshot."""
        addr = self._addr_of(peer_rank)
        if not addr:
            return False
        t0 = time.perf_counter()
        frame = _PEER_MAGIC + struct.pack(
            _PEER_HDR, _PEER_PUT, self.rank, int(step), int(epoch),
            zlib.crc32(blob) & 0xffffffff, len(blob))
        try:
            with socket.create_connection(
                    (addr["host"], addr["port"]), timeout=timeout) as c:
                c.settimeout(max(timeout, 60.0))
                c.sendall(frame)
                c.sendall(blob)
                ok = bytes(_recv_exact(c, 2)) == b"OK"
        except (OSError, KeyError, ConnectionError):
            return False
        if ok:
            self.stats["send_ms"] = (time.perf_counter() - t0) * 1e3
            telemetry.count("peer_snap.sends")
            telemetry.count("peer_snap.sent_bytes", len(blob))
        return ok

    def fetch(self, holder_rank, from_rank, step, timeout=5.0):
        """Pull ``from_rank``'s snapshot at ``step`` out of
        ``holder_rank``'s RAM; None when the holder does not have it.
        CRC-checked: a torn transfer raises CheckpointCorrupt."""
        t0 = time.perf_counter()
        if holder_rank == self.rank:
            got = self._unpack_held(from_rank, step)
            out = None if got is None else _from_wire(got[0])
            self.stats["fetch_ms"] = (time.perf_counter() - t0) * 1e3
            return out
        addr = self._addr_of(holder_rank)
        if not addr:
            return None
        frame = _PEER_MAGIC + struct.pack(
            _PEER_HDR, _PEER_GET, int(from_rank), int(step), 0, 0, 0)
        try:
            with socket.create_connection(
                    (addr["host"], addr["port"]), timeout=timeout) as c:
                c.settimeout(max(timeout, 60.0))
                c.sendall(frame)
                found, crc, nbytes = struct.unpack(
                    "<BIQ", bytes(_recv_exact(c, 13)))
                if not found:
                    return None
                blob = _recv_exact(c, nbytes)
        except (OSError, KeyError, ConnectionError):
            return None
        if zlib.crc32(blob) & 0xffffffff != crc:
            raise CheckpointCorrupt(
                f"peer snapshot rank {from_rank} step {step} from "
                f"holder {holder_rank}: checksum mismatch")
        telemetry.count("peer_snap.fetches")
        out = _from_wire(_peer_unwrap(pickle.loads(blob))[0])
        self.stats["fetch_ms"] = (time.perf_counter() - t0) * 1e3
        return out


def _apply_template(state, template, path="$"):
    """Walk state and template in lockstep: array leaves are checked
    against the template leaf (its shape and dtype where it has them) and
    placed on its device.  A structure, shape or dtype mismatch raises
    ``MXNetError``: a restore that silently mis-assigns tensors is worse
    than one that refuses."""
    import numpy as np

    def walk(s, t, path):
        if t is None:
            return s
        if isinstance(s, dict):
            if not isinstance(t, dict):
                raise MXNetError(f"template mismatch at {path}: state "
                                 f"has dict, template {type(t).__name__}")
            if set(s) != set(t):
                missing = sorted(set(s) - set(t))
                extra = sorted(set(t) - set(s))
                raise MXNetError(
                    f"template mismatch at {path}: keys differ "
                    f"(missing from template: {missing}, "
                    f"extra in template: {extra})")
            return {k: walk(v, t[k], f"{path}.{k}") for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            if not isinstance(t, (list, tuple)) or len(s) != len(t):
                raise MXNetError(
                    f"template mismatch at {path}: state has "
                    f"{type(s).__name__}[{len(s)}], template "
                    f"{type(t).__name__}"
                    f"[{len(t) if isinstance(t, (list, tuple)) else '?'}]")
            out = [walk(v, tv, f"{path}[{i}]")
                   for i, (v, tv) in enumerate(zip(s, t))]
            return out if isinstance(s, list) else tuple(out)
        if isinstance(s, np.ndarray) or isinstance(s, torch.Tensor):
            return _place_leaf(s, t, path)
        return s   # scalar: template position is ignored

    return walk(state, template, path)


def _as_restored_tensor(arr):
    """A restored leaf (numpy array, bf16 tensor) as a CPU tensor; 16-bit
    unsigned words as int16 (``_copy_leaf`` reads them as bf16 where the
    destination is bf16)."""
    import numpy as np

    leaf = _restored_leaf(arr)
    if isinstance(leaf, torch.Tensor):
        return leaf
    leaf = np.ascontiguousarray(leaf)
    if leaf.dtype == np.uint16:
        leaf = leaf.view(np.int16)
    return torch.from_numpy(leaf)


def _copy_leaf(dst, src):
    """Copy a restored leaf into a live tensor in place, bitwise: a bf16
    destination takes 16-bit words as they are."""
    t = _as_restored_tensor(src)
    if dst.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    dst.copy_(t.to(dst.device).view(dst.shape))


def _place_leaf(arr, tmpl, path):
    """A template leaf is a ``torch.device`` (or a device string), or a
    tensor whose shape, dtype and device the leaf must take."""
    t = _as_restored_tensor(arr)
    if isinstance(tmpl, torch.Tensor):
        if tuple(tmpl.shape) != tuple(t.shape):
            raise MXNetError(
                f"template mismatch at {path}: checkpoint leaf has shape "
                f"{tuple(t.shape)}, template wants {tuple(tmpl.shape)}")
        if tmpl.dtype != t.dtype:
            raise MXNetError(
                f"template mismatch at {path}: checkpoint leaf has dtype "
                f"{t.dtype}, template wants {tmpl.dtype}")
        return t.to(tmpl.device)
    if isinstance(tmpl, (torch.device, str)):
        return t.to(torch.device(tmpl))
    raise MXNetError(
        f"template leaf at {path} is {type(tmpl).__name__}; expected a "
        f"torch.device or a tensor (sharded placements come with the "
        f"multi-GPU slice)")


def make_checkpointer(directory, max_to_keep=3, async_save=None,
                      backend=None, logger=None, **kwargs):
    """Pick a checkpoint engine (`MXTPU_CKPT_BACKEND` or ``backend=``):

    - ``"native"`` (default): :class:`AsyncCheckpointer`: async saves,
      two-phase commit, CRC-checked restore;
    - ``"orbax"``: orbax is JAX's, so the native engine, with a log line
      (the JAX package's fallback when orbax is not installed);
    - ``"local"``: ``resilience.LocalCheckpointer`` (synchronous, one
      host).
    """
    backend = (backend or os.environ.get("MXTPU_CKPT_BACKEND")
               or "native").lower()
    log = (logger.info if logger is not None
           else lambda m: sys.stderr.write(f"[checkpoint] {m}\n"))
    if backend == "orbax":
        log("checkpoint backend: orbax requested but not available; "
            "falling back to the native async engine")
        backend = "native"
    if backend == "local":
        from .resilience import LocalCheckpointer

        log("checkpoint backend: local (synchronous, single-host)")
        return LocalCheckpointer(directory, max_to_keep=max_to_keep)
    if backend != "native":
        raise MXNetError(f"make_checkpointer: unknown backend "
                         f"{backend!r} (native / orbax / local)")
    ck = AsyncCheckpointer(directory, max_to_keep=max_to_keep,
                           async_save=async_save, logger=logger,
                           **kwargs)
    log(f"checkpoint backend: native (async={ck.async_save}, "
        f"rank {ck.rank}/{ck.world_size})")
    return ck


# -- trainer state ---------------------------------------------------------------

def _walk_state(s, fn):
    if isinstance(s, (list, tuple)):
        out = [_walk_state(v, fn) for v in s]
        return out if isinstance(s, list) else tuple(out)
    return fn(s)


def _live(v):
    """An NDArray's tensor; anything else as it is."""
    return getattr(v, "_data", v)


def _gluon_trainer_state(trainer):
    """``trainer_state`` of a ``gluon.Trainer``: the parameters in trainer
    order, the optimizer states keyed by trainer index (a multi-precision
    item's ``(f32 master, states)``) and the optimizer's update counters,
    everything ``load_trainer_state`` needs to resume the captured or the
    eager step bitwise."""
    upd = trainer._updaters[0]
    o = trainer._optimizer
    idxs = sorted(upd.states)
    return {
        "params": [p.data()._data for p in trainer._params],
        "opt_state": [_walk_state(upd.states[i], _live) for i in idxs],
        "opt_index": [int(i) for i in idxs],
        "num_update": int(o.num_update),
        "update_counts": {str(k): int(v)
                          for k, v in o._index_update_count.items()},
    }


def _gluon_load_trainer_state(trainer, state):
    """Copy a restored state into a ``gluon.Trainer``'s own tensors, in
    place (a captured step's recorded graph keeps reading them), creating
    the optimizer states the trainer has not made yet."""

    upd = trainer._updaters[0]
    o = trainer._optimizer
    with torch.no_grad():
        for p, v in zip(trainer._params, state["params"]):
            _copy_leaf(p.data()._data, v)
        for i, st in zip(state["opt_index"], state["opt_state"]):
            i = int(i)
            p = trainer._params[i]
            if i not in upd.states:
                upd.states[i] = o.create_state_multi_precision(i, p.data())
            cur = upd.states[i]

            def copy_into(dst, src):
                if isinstance(dst, (list, tuple)):
                    for d, s in zip(dst, src):
                        copy_into(d, s)
                    return
                t = _live(dst)
                if isinstance(t, torch.Tensor):
                    _copy_leaf(t, src)

            copy_into(cur, st)
            upd.states_synced[i] = True
    o.num_update = int(state["num_update"])
    o._index_update_count = {int(k): int(v) for k, v
                             in state["update_counts"].items()}
    return trainer


def _gluon_trainer_template(trainer):
    """``trainer_state_template`` of a ``gluon.Trainer``: each tensor
    position holds its parameter's device."""
    upd = trainer._updaters[0]
    devs = [p.data()._data.device for p in trainer._params]
    return {
        "params": devs,
        "opt_state": [_walk_state(upd.states[i], lambda _v, d=devs[i]: d)
                      for i in sorted(upd.states)],
        "opt_index": None,
        "num_update": None,
        "update_counts": None,
    }


def trainer_state(trainer, copy=True):
    """A trainer's full state as a pytree: a ``parallel.ShardedTrainer``
    or a ``gluon.Trainer`` (duck-typed on ``_trainable``).

    ``copy=True`` (the default) returns a snapshot of host numpy leaves
    (``snapshot_to_host``): restoring it is bitwise whatever the trainer
    did after the call.  ``copy=False`` returns the trainer's live
    tensors, for a caller that hands the tree straight to
    ``AsyncCheckpointer.save``, which orders its own copy before it
    returns (the card's leaves through pinned memory)."""
    if hasattr(trainer, "_trainable"):
        if not trainer._initialized:
            raise MXNetError("trainer_state: the ShardedTrainer has not "
                             "taken a step yet")
        trained = {n for n, _p in trainer._trainable}
        aux = {}
        if hasattr(trainer.block, "collect_params"):
            aux = {n: p._value() for n, p in
                   trainer.block.collect_params().items()
                   if n not in trained}
        state = {
            "params": [p for _n, p in trainer._trainable],
            "opt_state": [list(s) for s in trainer._opt_state],
            "aux": aux,
            "num_update": int(trainer._num_update),
        }
    else:
        state = _gluon_trainer_state(trainer)
    return snapshot_to_host(state) if copy else state


def trainer_state_template(trainer):
    """The restore ``template`` matching ``trainer_state``'s structure:
    each tensor position holds the device that tensor lives on."""
    if not hasattr(trainer, "_trainable"):
        return _gluon_trainer_template(trainer)
    dev = trainer._device
    state = trainer_state(trainer, copy=False)
    return {
        "params": [dev for _ in state["params"]],
        "opt_state": [[dev for _ in s] for s in state["opt_state"]],
        "aux": {k: dev for k in state["aux"]},
        "num_update": None,
    }


def load_trainer_state(trainer, state):
    """Load a restored pytree back into a trainer (duck-typed like
    ``trainer_state``), bitwise, into the trainer's own tensors."""
    if not hasattr(trainer, "_trainable"):
        return _gluon_load_trainer_state(trainer, state)
    if not trainer._initialized:
        raise MXNetError("load_trainer_state: stage the ShardedTrainer "
                         "with one step (or _stage) first")
    live = trainer_state(trainer, copy=False)
    with torch.no_grad():
        for dst, src in zip(live["params"], state["params"]):
            _copy_leaf(dst, src)
        for dsts, srcs in zip(live["opt_state"], state["opt_state"]):
            for dst, src in zip(dsts, srcs):
                _copy_leaf(dst, src)
        for k, dst in live["aux"].items():
            _copy_leaf(dst, state["aux"][k])
    trainer._num_update = int(state["num_update"])
    trainer.sync_params()
    return trainer


class PreemptionHandler:
    """Checkpoint on SIGTERM (a preemption notice): snapshot mid-epoch
    state in the grace window and go on or exit cleanly.

    Usable as a context manager (``with PreemptionHandler(...):``); it
    chains to any previously installed SIGTERM handler, so an outer
    supervisor's grace logic keeps running.  Install it from the main
    thread (Python's signal rule)."""

    def __init__(self, checkpointer, get_state, get_step):
        self._ckpt = checkpointer
        self._get_state = get_state
        self._get_step = get_step
        self.preempted = threading.Event()
        self._restored = False
        self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):
        self.preempted.set()
        # chain: a previously-installed python handler still runs
        if callable(self._prev):
            self._prev(signum, frame)

    def maybe_checkpoint(self):
        """Call at step boundaries; saves + returns True when preempted.

        If the checkpointer already has an in-flight async save, the
        grace window is spent COMPLETING that commit rather than
        starting a new one — the pending snapshot is consistent and
        already half-written; racing a second save against the clock
        risks ending the grace period with neither committed.
        """
        if not self.preempted.is_set():
            return False
        in_flight = getattr(self._ckpt, "in_flight", None)
        if in_flight is not None and in_flight():
            self._ckpt.wait()
            return True
        self._ckpt.save(self._get_step(), self._get_state())
        self._ckpt.wait()
        return True

    def restore_handler(self):
        if self._restored:
            return
        # signal.signal rejects None (getsignal returns None for handlers
        # not installed from python) — fall back to the default action
        signal.signal(signal.SIGTERM,
                      self._prev if self._prev is not None
                      else signal.SIG_DFL)
        self._restored = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.restore_handler()
        return False
