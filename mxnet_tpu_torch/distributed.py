"""Process bootstrap and the gang's file key-value store.

Counterpart of the one-process half of ``mxnet_tpu/distributed.py``
(lines 62-342): the launch contract ``MXTPU_COORDINATOR`` /
``MXTPU_NUM_WORKERS`` / ``MXTPU_WORKER_RANK`` (set by a launcher), a
retried rendezvous over ``torch.distributed`` (gloo on the CPU, NCCL on
the card; ``MXTPU_RENDEZVOUS_RETRIES`` attempts within
``MXTPU_RENDEZVOUS_TIMEOUT`` seconds, and the ``rendezvous`` fault site),
``rank`` / ``num_workers`` / ``barrier`` (watchdog-guarded by
``MXTPU_COLLECTIVE_TIMEOUT``), and :class:`FileKV`, the shared-directory
key-value store the integrity plane's votes and the serving replicas'
heartbeats ride.  A world of one opens no process group.

The network transports of the gang's control plane (``CoordKV``,
``GangKVServer``, ``TcpKV``) come with the gang slice: constructing one,
or asking ``gang_kv()`` for one, raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time

from . import resilience

_INITIALIZED = False

_GANG_SLICE = "comes with the gang slice of the port"


def _rendezvous(coordinator_address, num_processes, process_id):
    """Join the process group, retried: an unreachable coordinator is the
    retryable class, and the ``rendezvous`` fault site tests it on the
    CPU.  A world of one opens no process group."""
    timeout = float(os.environ.get("MXTPU_RENDEZVOUS_TIMEOUT", 300))
    retries = int(os.environ.get("MXTPU_RENDEZVOUS_RETRIES", 3))

    def attempt():
        resilience.inject_failure("rendezvous")
        if int(num_processes) <= 1:
            return
        import datetime

        import torch
        import torch.distributed as dist

        if dist.is_initialized():
            return
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=addr, world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout))

    resilience.retry_call(
        attempt, retries=retries, deadline=timeout, backoff=0.5,
        max_backoff=10.0,
        retryable=(RuntimeError, ConnectionError, OSError,
                   resilience.InjectedFault),
        description=f"rendezvous with {coordinator_address}")


def init_from_env():
    """Join the rendezvous if the launch variables are present; a no-op
    otherwise.  Returns True when running distributed."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coord = os.environ.get("MXTPU_COORDINATOR")
    if not coord:
        return False
    _rendezvous(coord, int(os.environ["MXTPU_NUM_WORKERS"]),
                int(os.environ["MXTPU_WORKER_RANK"]))
    _INITIALIZED = True
    from . import telemetry

    telemetry.set_identity(rank=int(os.environ["MXTPU_WORKER_RANK"]),
                           world=int(os.environ["MXTPU_NUM_WORKERS"]))
    return True


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Explicit init (reference analog: ps::Postoffice::Start)."""
    global _INITIALIZED
    _rendezvous(coordinator_address,
                1 if num_processes is None else num_processes,
                0 if process_id is None else process_id)
    _INITIALIZED = True


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def rank():
    """This process's rank in the process group (0 without one)."""
    dist = _group()
    return 0 if dist is None else dist.get_rank()


def num_workers():
    """The process group's size (1 without one)."""
    dist = _group()
    return 1 if dist is None else dist.get_world_size()


def barrier(name="mxtpu_barrier"):
    """Block until every process reaches this barrier; without a process
    group, drain the card's in-flight work.  Guarded by
    ``MXTPU_COLLECTIVE_TIMEOUT``: a dead peer gives a stack dump and a
    clean error instead of an endless hang.  The sync point of
    ``checkpoint.AsyncCheckpointer``'s two-phase commit across
    processes."""
    with resilience.guard_collective(f"barrier:{name}"):
        dist = _group()
        if dist is not None:
            dist.barrier()
            return
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The gang's control plane.
#
# The health plane must keep working *while a member is dead*, which a
# process-group barrier cannot do (it blocks on the dead peer).  So
# membership state lives in a plain KV store with no fate-sharing:
# writes are per-rank, reads never block on a peer.


class FileKV:
    """Shared-directory key-value store with atomic rename writes.

    Keys are slash-separated paths (``hb/0``, ``epoch/current``,
    ``epoch_ack/3/1``); values are bytes.  A write is tmp-file + rename,
    so readers see either the old or the new value, never a torn one.
    No locks, no daemons: any member (or an outside supervisor like
    ``tools/launch.py --elastic``) can read the gang's state at any
    time, including after every member is dead.
    """

    #: highest-committed-epoch fence, shared by every client of the dir
    _FENCE_KEY = ".epoch_fence"

    def __init__(self, root, rank=None):
        self.root = os.path.abspath(root)
        self.rank = rank
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key):
        if ".." in key.split("/"):
            raise ValueError(f"bad kv key: {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def _check_partition(self):
        if self.rank is not None and \
                resilience.partition_blocked(self.rank):
            raise GangKVError(
                f"rank {self.rank}: injected partition_split (gang dir "
                f"unreachable)")

    def put(self, key, value):
        self._check_partition()
        if isinstance(value, str):
            value = value.encode("utf-8")
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, key, default=None):
        self._check_partition()
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            return default

    def committed_epoch(self):
        """The highest epoch any ``put_if_epoch`` committed to this dir."""
        try:
            with open(os.path.join(self.root, self._FENCE_KEY)) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def put_if_epoch(self, key, value, epoch):
        """Fenced write: reject a mutation carrying an epoch OLDER than
        the highest epoch ever committed through this method (the
        Chubby-style fencing token).  Equal or newer epochs commit and
        advance the fence.  Lock-file + recheck: the fence read, the
        write, and the fence advance happen under an exclusive lock so
        two writers cannot interleave a stale write past a newer
        fence.  Raises :class:`FencedWrite` on rejection."""
        self._check_partition()
        epoch = int(epoch)
        lock = os.path.join(self.root, self._FENCE_KEY + ".lock")
        deadline = time.monotonic() + 5.0
        fd = None
        while fd is None:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if time.monotonic() > deadline:
                    # a crashed lock holder must not wedge the gang:
                    # break the stale lock and take it
                    try:
                        os.unlink(lock)
                    except FileNotFoundError:
                        pass
                else:
                    time.sleep(0.005)
        try:
            fence = self.committed_epoch()
            if epoch < fence:
                resilience._tel_event(
                    "fencing_rejected", rank=self.rank, epoch=epoch,
                    committed=fence, kind="kv", key=key)
                raise FencedWrite(
                    f"kv put {key!r} fenced: epoch {epoch} < committed "
                    f"epoch {fence}")
            self.put(key, value)
            if epoch > fence:
                fpath = os.path.join(self.root, self._FENCE_KEY)
                tmp = fpath + f".tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(str(epoch))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, fpath)
        finally:
            os.close(fd)
            try:
                os.unlink(lock)
            except FileNotFoundError:
                pass

    def put_json_if_epoch(self, key, obj, epoch):
        self.put_if_epoch(key, json.dumps(obj, sort_keys=True), epoch)

    def scan(self, prefix):
        """All (key, value) pairs under ``prefix`` (non-recursive)."""
        self._check_partition()
        base = self._path(prefix)
        try:
            names = sorted(os.listdir(base))
        except (FileNotFoundError, NotADirectoryError):
            return []
        out = []
        for name in names:
            if name.startswith(".") or ".tmp." in name:
                continue
            full = os.path.join(base, name)
            if not os.path.isfile(full):
                continue
            try:
                with open(full, "rb") as f:
                    out.append((f"{prefix}/{name}", f.read()))
            except FileNotFoundError:
                continue
        return out

    def delete(self, key):
        self._check_partition()
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    # JSON convenience layer — everything the gang publishes is JSON.
    def put_json(self, key, obj):
        self.put(key, json.dumps(obj, sort_keys=True))

    def get_json(self, key, default=None):
        raw = self.get(key)
        if raw is None:
            return default
        try:
            return json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return default


class GangKVError(resilience.MXNetError):
    """The TCP gang KV could not complete an operation (after retries
    and failover attempts) — or a `net_partition` / `partition_split`
    fault is armed for this rank."""


class FencedWrite(resilience.MXNetError):
    """A ``put_if_epoch`` mutation carried an epoch older than the
    highest committed one: the writer is on the losing side of a
    reshape (zombie or partition minority) and must not mutate shared
    state.  Deliberately NOT retryable — the fence only moves forward."""


class CoordKV:
    """The gang KV over a coordination service: comes with the gang
    slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"distributed.CoordKV {_GANG_SLICE}")


class GangKVServer:
    """The TCP gang KV daemon: comes with the gang slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"distributed.GangKVServer {_GANG_SLICE}")


class TcpKV:
    """The TCP gang KV client: comes with the gang slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"distributed.TcpKV {_GANG_SLICE}")


def gang_kv():
    """The control plane's KV transport, or None when there is nowhere to
    publish.  ``MXTPU_GANG_DIR`` gives a :class:`FileKV` (with
    ``MXTPU_GANG_KV=file`` or unset); ``MXTPU_GANG_KV=tcp`` /
    ``MXTPU_GANG_ADDR`` ask for the TCP transport, and a process group
    without a gang dir for the coordination-service one: both come with
    the gang slice and raise ``NotImplementedError``."""
    mode = (os.environ.get("MXTPU_GANG_KV") or "").strip().lower()
    addr = os.environ.get("MXTPU_GANG_ADDR")
    root = os.environ.get("MXTPU_GANG_DIR")
    if mode not in ("", "file", "tcp"):
        raise resilience.MXNetError(
            f"MXTPU_GANG_KV must be 'file' or 'tcp', got {mode!r}")
    if mode == "tcp" or (not mode and addr and not root):
        return TcpKV(addr)
    if mode == "file" and not root:
        raise resilience.MXNetError(
            "MXTPU_GANG_KV=file needs MXTPU_GANG_DIR")
    if root:
        r = os.environ.get("MXTPU_WORKER_RANK")
        return FileKV(root, rank=int(r) if r is not None else None)
    if num_workers() > 1:
        return CoordKV()
    return None
