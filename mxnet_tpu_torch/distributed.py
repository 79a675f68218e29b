"""Process bootstrap and the gang's control plane.

Counterpart of ``mxnet_tpu/distributed.py``:

- the launch contract ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_WORKERS`` /
  ``MXTPU_WORKER_RANK`` (set by a launcher), a retried rendezvous over
  ``torch.distributed`` (the backend by ``backend_rule`` over every
  rank's host and cards, gathered at the rendezvous: NCCL when each rank
  has a card of its own, gloo when ranks share a card or run on the CPU;
  ``MXTPU_RENDEZVOUS_RETRIES`` attempts within ``MXTPU_RENDEZVOUS_TIMEOUT``
  seconds, and the ``rendezvous`` fault site), ``rank`` / ``num_workers``
  / ``barrier`` (watchdog-guarded by ``MXTPU_COLLECTIVE_TIMEOUT``).  A
  world of one opens no process group.
- the gang KV, the store the elastic gang's membership, heartbeats and
  votes live in, which keeps working while a member is dead:
  :class:`FileKV` (a shared directory, ``MXTPU_GANG_DIR``),
  :class:`GangKVServer` and its client :class:`TcpKV` (stdlib TCP with
  leases, watches, the ``put_if_epoch`` fence and coordinator failover;
  ``MXTPU_GANG_ADDR``), and :class:`CoordKV` (the process group's own
  store).  ``gang_kv()`` picks one.  The TCP frame is the JAX package's
  (``MXTPGKV1``), so the two packages' clients and servers interoperate.

Settings: ``MXTPU_LEASE_TTL`` (a lease's seconds, default 10),
``MXTPU_KV_TIMEOUT`` (an RPC's seconds, 5), ``MXTPU_KV_RETRIES`` (10),
``MXTPU_KV_MAX_ELAPSED`` (a cap on an operation's retries in seconds, off
by default), ``MXTPU_KV_FAILOVER_STAGGER`` (0.5 s between the failover
candidates' promotions).
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import struct
import threading
import time
import zlib

from . import resilience

_INITIALIZED = False


def local_member():
    """This rank's entry in ``backend_rule``'s list: (host name, CUDA
    cards visible here, whether the rank runs on the host because a
    ``with cpu():`` scope is open)."""
    import torch

    from . import context

    scope = context.scoped_context()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return (socket.gethostname(), int(cards),
            scope is not None and scope.device_type == "cpu")


def backend_rule(members):
    """(backend, reason) for a process group whose ranks are ``members``,
    one ``local_member()`` triple a rank: NCCL when each rank has a card
    of its own, that is, on every host no more ranks than that host's
    cards; gloo when ranks share a card on some host (NCCL refuses two
    ranks on one device), when a host has no card, or when a rank runs on
    the host (a ``cpu`` scope).  Every rank publishes its triple at the
    rendezvous and reads all of them, so every rank picks the same
    backend."""
    members = [tuple(m) for m in members]
    if any(on_host for _, _, on_host in members):
        return "gloo", "the ranks run on the host (cpu scope)"
    ranks, cards = {}, {}
    for host, n, _ in members:
        ranks[host] = ranks.get(host, 0) + 1
        cards[host] = min(cards.get(host, n), n)
    for host in sorted(ranks):
        if cards[host] == 0:
            return "gloo", (f"no CUDA card is visible on {host}: the ranks "
                            "run on the host")
        if ranks[host] > cards[host]:
            return "gloo", (f"{ranks[host]} ranks share {cards[host]} "
                            f"card(s) on {host}; NCCL refuses two ranks on "
                            "one device")
    return "nccl", (f"{len(members)} ranks on {len(ranks)} host(s), one "
                    "card each")


def _rendezvous(coordinator_address, num_processes, process_id):
    """Join the process group, retried: an unreachable coordinator is the
    retryable class, and the ``rendezvous`` fault site tests it on the
    CPU.  A world of one opens no process group.  The ranks meet at the
    coordinator's store first, each writes its ``local_member()`` there
    and reads every rank's, and the group opens on the backend
    ``backend_rule`` picks from that list; the rank prints its choice and
    the reason."""
    timeout = float(os.environ.get("MXTPU_RENDEZVOUS_TIMEOUT", 300))
    retries = int(os.environ.get("MXTPU_RENDEZVOUS_RETRIES", 3))

    def attempt():
        resilience.inject_failure("rendezvous")
        if int(num_processes) <= 1:
            return
        import datetime

        import torch.distributed as dist

        if dist.is_initialized():
            return
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        n, rank = int(num_processes), int(process_id)
        wait = datetime.timedelta(seconds=timeout)
        store, _, _ = next(dist.rendezvous(addr, rank=rank, world_size=n,
                                           timeout=wait))
        _open_group(store, "default_pg", n, rank, wait)

    resilience.retry_call(
        attempt, retries=retries, deadline=timeout, backoff=0.5,
        max_backoff=10.0,
        retryable=(RuntimeError, ConnectionError, OSError,
                   resilience.InjectedFault),
        description=f"rendezvous with {coordinator_address}")


def _open_group(store, prefix, n, rank, wait):
    """The default process group of ``n`` ranks over ``store``: each rank
    writes its ``local_member()`` under ``prefix``, reads all of them, and
    the group opens on the backend ``backend_rule`` picks (printed with
    its reason)."""
    import torch.distributed as dist

    store.set_timeout(wait)
    store.set(f"{prefix}/mxtpu_member/{rank}", json.dumps(local_member()))
    members = [json.loads(store.get(f"{prefix}/mxtpu_member/{r}"))
               for r in range(n)]
    backend, reason = backend_rule(members)
    print(f"[rank {rank}] process group backend {backend}: {reason}",
          flush=True)
    dist.init_process_group(
        backend, store=dist.PrefixStore(prefix, store), world_size=n,
        rank=rank, timeout=wait)
    return backend


#: the TCP store under the gang's current process group (the leader
#: serves it; kept for the group's life)
_GANG_STORE = [None]


def form_group(kv, epoch, members, rank, timeout=60.0):
    """Form the default process group anew over the gang's ``members`` of
    ``epoch``: world ``len(members)``, this rank's place its index in
    ``members``.  A group already open (the previous epoch's, perhaps
    with a dead peer) is destroyed first.  The rendezvous goes through the
    gang's KV ``kv`` under ``pg/<epoch>/``: the first member serves a TCP
    store and publishes its address there, the others read it; the group
    opens on ``backend_rule``'s backend with collectives that time out
    after ``timeout`` seconds (a dead peer fails the call instead of
    hanging it).  A gang of one opens no group.  Returns the backend, or
    None for one member."""
    import datetime

    import torch.distributed as dist

    leave_group()
    members = [int(m) for m in members]
    n, place = len(members), members.index(int(rank))
    if n == 1:
        return None
    wait = datetime.timedelta(seconds=float(timeout))
    key = f"pg/{int(epoch)}/store"
    if place == 0:
        host = _reachable_host(kv)
        store = dist.TCPStore(host, 0, n, is_master=True, timeout=wait,
                              wait_for_workers=False)
        kv.put_json(key, {"host": host, "port": int(store.port)})
    else:
        deadline = time.monotonic() + float(timeout)
        while True:
            at = kv.get_json(key)
            if at is not None:
                break
            if time.monotonic() > deadline:
                raise resilience.MXNetError(
                    f"form_group: no store for epoch {epoch} after "
                    f"{timeout} s")
            time.sleep(0.01)
        store = dist.TCPStore(at["host"], int(at["port"]), n,
                              is_master=False, timeout=wait)
    _GANG_STORE[0] = store
    return _open_group(store, f"gang_pg/{int(epoch)}", n, place, wait)


def leave_group():
    """Destroy the default process group, if one is open, and drop the
    gang's store: every peer's pending or next collective with this rank
    fails."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GANG_STORE[0] = None


def _reachable_host(kv):
    """The address this host reaches the gang KV from (so its peers reach
    this host at it too); the loopback for a KV without a socket."""
    sock = getattr(kv, "_conn", None)
    try:
        return sock.getsockname()[0]
    except (AttributeError, OSError):
        return "127.0.0.1"


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


# ---------------------------------------------------------------------------
# The TCP gang KV: GangKVServer and its client TcpKV.
#
# The JAX package's frame, byte for byte: magic, a fixed header (code,
# CRC32, length) and a pickled payload, so a torn or corrupted frame is
# a clean error, never a mis-parse, and either package's client talks to
# either package's server.


_KV_MAGIC = b"MXTPGKV1"
_KV_HDR = struct.Struct("<BIQ")   # code u8 | crc32 u32 | payload_len u64
_KV_MAX_FRAME = 64 << 20          # control-plane values are small

(_OP_PUT, _OP_GET, _OP_SCAN, _OP_DEL, _OP_RENEW, _OP_WATCH,
 _OP_STATE, _OP_PING, _OP_PUT_IF_EPOCH) = range(1, 10)
_ST_OK, _ST_ERR = 0, 1

_OP_NAMES = {_OP_PUT: "put", _OP_GET: "get", _OP_SCAN: "scan",
             _OP_DEL: "delete", _OP_RENEW: "renew", _OP_WATCH: "watch",
             _OP_STATE: "state", _OP_PING: "ping",
             _OP_PUT_IF_EPOCH: "put_if_epoch"}

#: server-side error prefix a fenced mutation comes back with; the
#: client turns it into :class:`FencedWrite` instead of retrying
_FENCED_ERR = "fenced:"


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gang kv: peer closed mid-frame")
        buf += chunk
    return buf


def _kv_send(conn, code, obj):
    payload = pickle.dumps(obj, protocol=4)
    hdr = _KV_HDR.pack(code, zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload))
    conn.sendall(_KV_MAGIC + hdr + payload)


def _kv_recv(conn):
    raw = _recv_exact(conn, len(_KV_MAGIC) + _KV_HDR.size)
    if raw[:len(_KV_MAGIC)] != _KV_MAGIC:
        raise ConnectionError("gang kv: bad frame magic")
    code, crc, length = _KV_HDR.unpack(raw[len(_KV_MAGIC):])
    if length > _KV_MAX_FRAME:
        raise ConnectionError(f"gang kv: oversized frame ({length} B)")
    payload = _recv_exact(conn, length)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ConnectionError("gang kv: frame CRC mismatch")
    return code, pickle.loads(payload)


def _check_kv_key(key):
    if ".." in key.split("/"):
        raise ValueError(f"bad kv key: {key!r}")
    return key


def lease_ttl_from_env(default=10.0):
    try:
        return max(0.1, float(os.environ.get("MXTPU_LEASE_TTL", default)))
    except ValueError:
        return default


class GangKVServer:
    """Stdlib-only gang KV daemon: a dict + leases + watch conditions
    behind the framed TCP protocol above.

    - keys → bytes, exactly the FileKV namespace; ``scan`` is
      non-recursive (direct children only), sorted.
    - leases: a PUT may carry a lease id; a sweeper deletes every key of
      a lease whose client stopped renewing for ``lease_ttl`` — the
      heartbeat files' mtime-freshness, without a filesystem.
    - watches: every mutation bumps a global version and notifies; a
      WATCH long-polls until some key under its prefix changes past the
      version the client last saw.
    - failover seeding: ``state=``/``version=`` restart the store from a
      client's cached STATE frame (the promoted coordinator's replay);
      ``sock=`` serves on a pre-bound standby socket.

    The ``kill_coordinator`` fault site makes the daemon drop dead on
    the next mutation — mid-protocol, connections cut, no reply — which
    is exactly what the client failover path must survive.
    """

    def __init__(self, host="127.0.0.1", port=0, *, lease_ttl=None,
                 state=None, version=0, leases=None, sock=None,
                 fence=0):
        self.lease_ttl = (lease_ttl_from_env() if lease_ttl is None
                          else float(lease_ttl))
        self._fence = int(fence)    # highest committed gang epoch
        self._data = {}
        for k, v in (state or {}).items():
            self._data[k] = v if isinstance(v, bytes) else \
                str(v).encode("utf-8")
        self._ver = int(version)
        self._key_ver = {k: self._ver for k in self._data}
        now = time.monotonic()
        self._leases = {}
        for lid, keys in (leases or {}).items():
            self._leases[lid] = {"deadline": now + self.lease_ttl,
                                 "keys": set(keys)}
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._conns = set()
        self._threads = []
        self.requests = 0
        self.died = False           # killed by fault injection
        if sock is not None:
            self._sock = sock
        else:
            self._sock = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
            self._sock.bind((host, int(port)))
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread = None

    @property
    def addr(self):
        return f"{self.host}:{self.port}"

    def start(self):
        if self._accept_thread is None:
            self._sock.listen(64)
            self._sock.settimeout(0.2)
            self._accept_thread = threading.Thread(
                target=self._serve, name=f"gang-kv:{self.port}",
                daemon=True)
            self._accept_thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)

    # alias: a killed coordinator and a stopped one look the same to
    # clients; tests use die() to simulate coordinator death in-process
    def die(self):
        self.died = True
        self.stop()

    def _serve(self):
        while not self._stop.is_set():
            self._sweep_leases()
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(60.0)
            self._conns.add(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()

    def _sweep_leases(self):
        now = time.monotonic()
        with self._cond:
            expired = [lid for lid, l in self._leases.items()
                       if l["deadline"] < now]
            changed = False
            for lid in expired:
                for k in self._leases.pop(lid)["keys"]:
                    if k in self._data:
                        del self._data[k]
                        self._ver += 1
                        self._key_ver[k] = self._ver
                        changed = True
            if changed:
                self._cond.notify_all()

    def _handle(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    code, args = _kv_recv(conn)
                except (ConnectionError, OSError, EOFError,
                        pickle.UnpicklingError):
                    return
                self.requests += 1
                if code in (_OP_PUT, _OP_DEL) and \
                        resilience.consume_charges("kill_coordinator"):
                    # fires on the LAST charge: the Nth mutation of a
                    # kill_coordinator:N plan
                    # injected coordinator death: cut every client off
                    # mid-request, no reply — the worst-timed crash
                    self.die()
                    return
                try:
                    resp = self._dispatch(code, args)
                except ValueError as e:
                    _kv_send(conn, _ST_ERR, f"{e}")
                    continue
                try:
                    _kv_send(conn, _ST_OK, resp)
                except OSError:
                    return
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, code, args):
        if code == _OP_PUT:
            key, value, lease_id = args
            _check_kv_key(key)
            with self._cond:
                self._data[key] = value
                self._ver += 1
                self._key_ver[key] = self._ver
                if lease_id:
                    lease = self._leases.setdefault(
                        lease_id, {"deadline": 0.0, "keys": set()})
                    lease["keys"].add(key)
                    lease["deadline"] = time.monotonic() + self.lease_ttl
                self._cond.notify_all()
                return self._ver
        if code == _OP_PUT_IF_EPOCH:
            key, value, epoch = args
            _check_kv_key(key)
            epoch = int(epoch)
            with self._cond:
                if epoch < self._fence:
                    raise ValueError(
                        f"{_FENCED_ERR} put {key!r} epoch {epoch} < "
                        f"committed epoch {self._fence}")
                self._data[key] = value
                self._ver += 1
                self._key_ver[key] = self._ver
                self._fence = max(self._fence, epoch)
                self._cond.notify_all()
                return self._ver
        if code == _OP_GET:
            with self._cond:
                return self._data.get(args[0])
        if code == _OP_SCAN:
            pref = args[0].rstrip("/") + "/"
            with self._cond:
                return [(k, self._data[k]) for k in sorted(self._data)
                        if k.startswith(pref)
                        and "/" not in k[len(pref):]]
        if code == _OP_DEL:
            key = args[0]
            with self._cond:
                if key in self._data:
                    del self._data[key]
                    self._ver += 1
                    self._key_ver[key] = self._ver
                    self._cond.notify_all()
                for lease in self._leases.values():
                    lease["keys"].discard(key)
                return self._ver
        if code == _OP_RENEW:
            lease_id, keys = args
            with self._cond:
                lease = self._leases.setdefault(
                    lease_id, {"deadline": 0.0, "keys": set()})
                lease["deadline"] = time.monotonic() + self.lease_ttl
                lease["keys"] |= {k for k in keys if k in self._data}
                return self._ver
        if code == _OP_WATCH:
            prefix, since, timeout = args
            deadline = time.monotonic() + min(float(timeout), 30.0)
            with self._cond:
                start = self._ver if since is None else int(since)
                while not self._stop.is_set():
                    if any(v > start for k, v in self._key_ver.items()
                           if k.startswith(prefix)):
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(min(left, 0.5))
                return self._ver
        if code == _OP_STATE:
            with self._cond:
                return (self._ver, dict(self._data),
                        {lid: sorted(l["keys"])
                         for lid, l in self._leases.items()},
                        self._fence)
        if code == _OP_PING:
            return self._ver
        raise ValueError(f"gang kv: unknown op {code}")


class TcpKV:
    """FileKV-compatible client for :class:`GangKVServer`.

    Same ``put/get/scan/delete`` + JSON surface, plus:

    - leases: keys under ``ephemeral_prefixes`` (heartbeats, failover
      candidacy) are attached to this client's lease and renewed by a
      background thread; when the process dies the server expires them
      — the replacement for heartbeat-file mtime freshness.
    - ``watch(prefix)``: blocking long-poll until a key under the
      prefix changes — the replacement for directory rescans.
    - coordinator failover: the client keeps (a) a standby socket bound
      at construction and advertised at ``failover/<rank>``, (b) a state
      frame refreshed on every lease renewal, and (c) an LRU of its own
      recent writes.  When the coordinator dies, each retry pings the
      standby addresses of lower-ranked clients; the lowest live rank
      promotes itself (re-binds, replays the state frame), everyone
      else adopts the promoted address and replays its own writes —
      which is also what re-proposes an interrupted epoch proposal
      (epoch/current is one of the proposer's recent writes).
    """

    _REPLAY_KEYS = 256   # per-client write LRU replayed after failover

    def __init__(self, addr=None, *, rank=None, lease_ttl=None,
                 ephemeral_prefixes=("hb/", "failover/"), standby=None,
                 timeout=None):
        addr = addr or os.environ.get("MXTPU_GANG_ADDR")
        if not addr:
            raise resilience.MXNetError(
                "TcpKV needs an address (MXTPU_GANG_ADDR=host:port)")
        host, _, port = addr.rpartition(":")
        self._host, self._port = host or "127.0.0.1", int(port)
        if rank is None:
            r = os.environ.get("MXTPU_WORKER_RANK")
            rank = int(r) if r is not None else None
        self.rank = rank
        self._timeout = float(
            os.environ.get("MXTPU_KV_TIMEOUT", 5.0)
            if timeout is None else timeout)
        self._ttl = (lease_ttl_from_env() if lease_ttl is None
                     else float(lease_ttl))
        self._eph = tuple(ephemeral_prefixes)
        self._lease_id = (f"r{rank if rank is not None else 'x'}."
                          f"{os.getpid()}.{os.urandom(3).hex()}")
        self._stagger = float(
            os.environ.get("MXTPU_KV_FAILOVER_STAGGER", 0.5))
        self._retries = int(os.environ.get("MXTPU_KV_RETRIES", 10))
        # total-elapsed retry budget (s): bounds partition-era retries so
        # callers fail over to fencing checks instead of spinning forever
        try:
            self._max_elapsed = float(
                os.environ.get("MXTPU_KV_MAX_ELAPSED", "0")) or None
        except ValueError:
            self._max_elapsed = None
        self._conn = None
        self._conn_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._state = ({}, 0, 0)     # (data, version, fence) — failover seed
        self._written = {}           # key -> value LRU (failover replay)
        self._leased = set()
        self._down_since = None
        self._fo_lock = threading.Lock()
        self._server = None          # set if this client promoted
        self.failovers = 0
        self.closed = False
        self._standby = None
        if standby is None:
            standby = rank is not None
        if standby:
            self._standby = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
            self._standby.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
            # bound but NOT listening: pings get ECONNREFUSED until the
            # promotion actually happens
            self._standby.bind((self._host if self._host != "0.0.0.0"
                                else "127.0.0.1", 0))
        self._stop = threading.Event()
        self._renewer = threading.Thread(
            target=self._renew_loop, name=f"gang-kv-lease:{rank}",
            daemon=True)
        self._renewer.start()
        if self._standby is not None:
            sh, sp = self._standby.getsockname()[:2]
            try:
                self.put_json(f"failover/{self.rank}",
                              {"rank": self.rank, "host": sh,
                               "port": sp})
            except Exception:   # noqa: BLE001 — registered on reconnect
                pass
        try:
            self._refresh_state()
        except Exception:       # noqa: BLE001 — refreshed by renewals
            pass

    # -- transport -------------------------------------------------------------

    def _connect(self):
        conn = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _rpc(self, op, args, timeout=None):
        with self._conn_lock:
            try:
                if self._conn is None:
                    self._conn = self._connect()
                self._conn.settimeout(timeout or self._timeout)
                _kv_send(self._conn, op, args)
                code, obj = _kv_recv(self._conn)
            except (OSError, EOFError, ConnectionError,
                    pickle.UnpicklingError) as e:
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                    self._conn = None
                raise ConnectionError(f"gang kv rpc failed: {e}") from e
        if code == _ST_ERR:
            raise ValueError(str(obj))
        self._down_since = None
        return obj

    def _call(self, op, *args, timeout=None):
        if self.rank is not None and \
                self.rank in resilience.fault_args("net_partition"):
            raise GangKVError(
                f"rank {self.rank}: injected net partition")
        if self.rank is not None and \
                resilience.partition_blocked(self.rank):
            raise GangKVError(
                f"rank {self.rank}: injected partition_split "
                f"(coordinator unreachable)")

        def attempt():
            return self._rpc(op, args, timeout=timeout)

        def on_retry(_attempt, _exc, _sleep):
            self._maybe_failover()

        try:
            return resilience.retry_call(
                attempt, retries=self._retries, backoff=0.05,
                max_backoff=0.5, jitter=True,
                max_elapsed=self._max_elapsed,
                retryable=(ConnectionError, OSError),
                on_retry=on_retry,
                description=f"gang kv {_OP_NAMES.get(op, op)}")
        except (ConnectionError, OSError) as e:
            raise GangKVError(f"gang kv unreachable at "
                              f"{self._host}:{self._port}: {e}") from e

    # -- failover --------------------------------------------------------------

    def _refresh_state(self):
        frame = self._rpc(_OP_STATE, ())
        ver, data, leases = frame[:3]
        fence = frame[3] if len(frame) > 3 else 0
        with self._state_lock:
            self._state = (data, ver, fence)
        return ver

    def _candidates(self):
        with self._state_lock:
            data = dict(self._state[0])
        cands = []
        for key, raw in data.items():
            if not key.startswith("failover/"):
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
                cands.append((int(rec["rank"]), rec["host"],
                              int(rec["port"])))
            except (ValueError, KeyError, UnicodeDecodeError):
                continue
        return sorted(cands)

    def _maybe_failover(self):
        now = time.monotonic()
        if self._down_since is None:
            self._down_since = now
            return
        with self._fo_lock:
            if self._server is not None:
                return      # already promoted; retries hit our server
            cands = self._candidates()
            for idx, (r, host, port) in enumerate(cands):
                if r == self.rank:
                    if now - self._down_since >= idx * self._stagger:
                        self._promote()
                    return
                try:
                    conn = socket.create_connection((host, port),
                                                    timeout=0.25)
                    try:
                        _kv_send(conn, _OP_PING, ())
                        _kv_recv(conn)
                    finally:
                        conn.close()
                except (OSError, ConnectionError):
                    continue
                self._adopt(host, port)
                return

    def _promote(self):
        """Become the coordinator: listen on the standby socket, replay
        the last state frame, then replay our own recent writes."""
        if self._standby is None:
            return
        with self._state_lock:
            data, ver, fence = (dict(self._state[0]), self._state[1],
                                self._state[2])
        srv = GangKVServer(lease_ttl=self._ttl, state=data,
                           version=ver + 1, sock=self._standby,
                           fence=fence)
        srv.start()
        self._server = srv
        self._standby = None
        self._host, self._port = srv.host, srv.port
        self._down_since = None
        self.failovers += 1
        resilience._tel_event("coordinator_failover", rank=self.rank,
                              addr=srv.addr, role="promoted",
                              replayed_keys=len(data))
        self._replay_writes()

    def _adopt(self, host, port):
        self._host, self._port = host, port
        self._down_since = None
        self.failovers += 1
        resilience._tel_event("coordinator_reconnect", rank=self.rank,
                              addr=f"{host}:{port}")
        self._replay_writes()

    def _replay_writes(self):
        """Re-put this client's recent writes against the (new)
        coordinator: resumes our leases and re-proposes any epoch record
        this rank was mid-writing when the old coordinator died."""
        for key, value in list(self._written.items()):
            lease = self._lease_id if self._is_ephemeral(key) else None
            try:
                self._rpc(_OP_PUT, (key, value, lease))
            except (ConnectionError, OSError, ValueError):
                return

    # -- lease renewal ---------------------------------------------------------

    def _renew_loop(self):
        interval = max(0.05, min(self._ttl / 3.0, 2.0))
        last_ver = -1
        while not self._stop.wait(interval):
            try:
                ver = self._call(_OP_RENEW,
                                 self._lease_id, sorted(self._leased))
                if ver != last_ver:
                    last_ver = self._refresh_state()
            except Exception:   # noqa: BLE001 — next op retries/fails over
                pass

    def _is_ephemeral(self, key):
        return any(key.startswith(p) for p in self._eph)

    # -- the FileKV surface ----------------------------------------------------

    def put(self, key, value):
        _check_kv_key(key)
        if isinstance(value, str):
            value = value.encode("utf-8")
        lease = None
        if self._is_ephemeral(key):
            lease = self._lease_id
            self._leased.add(key)
        self._written[key] = value
        if len(self._written) > self._REPLAY_KEYS:
            self._written.pop(next(iter(self._written)))
        self._call(_OP_PUT, key, value, lease)

    def put_if_epoch(self, key, value, epoch):
        """Fenced write (server-side check): rejected with
        :class:`FencedWrite` when ``epoch`` is older than the highest
        epoch any client committed.  Fenced keys are deliberately kept
        OUT of the failover-replay LRU — replaying a stale epoch record
        after a partition heals is exactly the split-brain vector the
        fence exists to close."""
        _check_kv_key(key)
        if isinstance(value, str):
            value = value.encode("utf-8")
        try:
            return self._call(_OP_PUT_IF_EPOCH, key, value, int(epoch))
        except ValueError as e:
            if str(e).startswith(_FENCED_ERR):
                resilience._tel_event(
                    "fencing_rejected", rank=self.rank,
                    epoch=int(epoch), kind="kv", key=key)
                raise FencedWrite(str(e)) from e
            raise

    def put_json_if_epoch(self, key, obj, epoch):
        return self.put_if_epoch(key, json.dumps(obj, sort_keys=True),
                                 epoch)

    def committed_epoch(self):
        """The coordinator's highest committed gang epoch (the fence).

        The full state frame comes back with the answer, so it also
        refreshes this client's failover seed — a promotion right
        after a fence check replays the fence it just read, instead of
        a frame from the last (possibly seconds-old) lease renewal."""
        frame = self._call(_OP_STATE)
        ver, data, _leases = frame[:3]
        fence = frame[3] if len(frame) > 3 else 0
        with self._state_lock:
            self._state = (data, ver, fence)
        return fence

    def get(self, key, default=None):
        _check_kv_key(key)
        value = self._call(_OP_GET, key)
        return default if value is None else value

    def scan(self, prefix):
        return [(k, v) for k, v in self._call(_OP_SCAN, prefix)]

    def delete(self, key):
        self._written.pop(key, None)
        self._leased.discard(key)
        self._call(_OP_DEL, key)

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

    # -- extras over FileKV ----------------------------------------------------

    def watch(self, prefix, since=None, timeout=1.0):
        """Block until a key under ``prefix`` changes (or ``timeout``).
        Returns the server's version counter — pass it back as
        ``since`` to never miss a change between calls.  Best-effort:
        returns ``since`` on transport failure (callers fall back to
        their polling loop).  Uses a dedicated connection so a long
        poll never blocks the pooled one (heartbeats keep flowing)."""
        try:
            conn = self._connect()
            try:
                conn.settimeout(timeout + self._timeout)
                _kv_send(conn, _OP_WATCH, (prefix, since, timeout))
                code, obj = _kv_recv(conn)
            finally:
                conn.close()
            if code == _ST_ERR:
                raise ValueError(str(obj))
            return obj
        except (ConnectionError, OSError):
            self._maybe_failover()
            return since

    def ping(self):
        return self._call(_OP_PING)

    def close(self, stop_server=True):
        self.closed = True
        self._stop.set()
        self._renewer.join(timeout=2.0)
        with self._conn_lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
        if self._standby is not None:
            try:
                self._standby.close()
            except OSError:
                pass
        if stop_server and self._server is not None:
            self._server.stop()


class CoordKV:
    """The gang KV over the store of ``torch.distributed``'s default
    process group (the TCPStore ``_rendezvous`` opens), in place of the
    JAX package's coordination-service client; keys live under
    ``mxtpu_gang/``.

    Best-effort, as in the JAX package: the store's server lives in rank
    0's process, so this transport dies with rank 0 and covers only the
    deaths of other ranks.  Deployments that need rank 0's death covered
    point ``MXTPU_GANG_DIR`` at a shared directory or ``MXTPU_GANG_ADDR``
    at a :class:`GangKVServer`.

    A store lists no keys and blocks on a missing one, so a value is
    stored with a one-byte tag (``1`` present, ``0`` deleted: a delete
    leaves a tombstone, and a read never blocks once ``check`` saw the
    key), and each parent path keeps an appended index of its children's
    names, which ``scan`` reads.
    """

    _PREFIX = "mxtpu_gang/"
    _INDEX = "mxtpu_gang_index/"

    def __init__(self, store=None):
        if store is None:
            from torch.distributed import distributed_c10d as _c10d

            store = _c10d._get_default_store()
        self._store = store
        self._indexed = set()
        self._lock = threading.Lock()

    def _read(self, key):
        k = self._PREFIX + key
        if not self._store.check([k]):
            return None
        raw = bytes(self._store.get(k))
        return raw[1:] if raw[:1] == b"\x01" else None

    def put(self, key, value):
        _check_kv_key(key)
        if isinstance(value, str):
            value = value.encode("utf-8")
        self._store.set(self._PREFIX + key, b"\x01" + bytes(value))
        with self._lock:
            new = key not in self._indexed
            self._indexed.add(key)
        if new:
            parent, _, name = key.rpartition("/")
            self._store.append(self._INDEX + parent, name + "\n")

    def get(self, key, default=None):
        _check_kv_key(key)
        value = self._read(key)
        return default if value is None else value

    def scan(self, prefix):
        parent = prefix.rstrip("/")
        idx = self._INDEX + parent
        if not self._store.check([idx]):
            return []
        names = sorted(set(
            n for n in bytes(self._store.get(idx)).decode("utf-8")
            .split("\n") if n))
        out = []
        for name in names:
            key = f"{parent}/{name}" if parent else name
            value = self._read(key)
            if value is not None:
                out.append((key, value))
        return out

    def delete(self, key):
        k = self._PREFIX + key
        if self._store.check([k]):
            self._store.set(k, b"\x00")

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


_TCP_KV_CACHE = {}


def _tcp_gang_kv(addr):
    """Per-process TcpKV singleton: one lease + one standby socket per
    (address, rank), however many times gang_kv() is called."""
    rank = os.environ.get("MXTPU_WORKER_RANK")
    key = (addr, rank)
    kv = _TCP_KV_CACHE.get(key)
    if kv is None or kv.closed:
        kv = TcpKV(addr)
        _TCP_KV_CACHE[key] = kv
    return kv


def gang_kv():
    """The elastic control plane's KV transport, or None when there is
    nowhere to publish (no gang dir or address, no process group).
    ``MXTPU_GANG_KV=file|tcp`` chooses; otherwise ``MXTPU_GANG_ADDR``
    means tcp and ``MXTPU_GANG_DIR`` file (the directory wins when both
    are set), else the process group's store (:class:`CoordKV`)."""
    mode = (os.environ.get("MXTPU_GANG_KV") or "").strip().lower()
    addr = os.environ.get("MXTPU_GANG_ADDR")
    root = os.environ.get("MXTPU_GANG_DIR")
    if mode not in ("", "file", "tcp"):
        raise resilience.MXNetError(
            f"MXTPU_GANG_KV must be 'file' or 'tcp', got {mode!r}")
    if mode == "tcp" or (not mode and addr and not root):
        if not addr:
            raise resilience.MXNetError(
                "MXTPU_GANG_KV=tcp needs MXTPU_GANG_ADDR=host:port")
        return _tcp_gang_kv(addr)
    if mode == "file" and not root:
        raise resilience.MXNetError(
            "MXTPU_GANG_KV=file needs MXTPU_GANG_DIR")
    if root:
        r = os.environ.get("MXTPU_WORKER_RANK")
        return FileKV(root, rank=int(r) if r is not None else None)
    if _group() is not None:
        return CoordKV()
    return None
