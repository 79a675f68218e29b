"""Checkpointing: async, two-phase-committed, CRC-checked snapshots.

Counterpart of ``mxnet_tpu/checkpoint.py`` less ``PeerSnapshotStore``
(the gang slice's).  :class:`AsyncCheckpointer` is the engine:

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

    def _snapshot_local(self, leaves):
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
            if i % self.world_size != self.rank:
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
        """Peer RAM replication (``PeerSnapshotStore``) comes with the gang
        slice."""
        raise NotImplementedError(
            "AsyncCheckpointer.attach_peers: PeerSnapshotStore comes with "
            "the gang slice of the port")

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
        prevent)."""
        self._join(raise_error=False)
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        mpath = os.path.join(self._step_dir(step), "MANIFEST.json")
        if not os.path.exists(mpath):
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


class PeerSnapshotStore:
    """Peer-replicated in-memory snapshots for elastic recovery: come with
    the gang slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpoint.PeerSnapshotStore comes with the gang slice of the "
            "port")

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
