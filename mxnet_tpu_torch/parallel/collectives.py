"""Collectives over the process group, and the regions of a sharded step.

Counterpart of ``mxnet_tpu/parallel/collectives.py``.  The JAX package
runs each collective as a small jitted program over a device mesh; here
a rank holds its own tensor and the collective runs over the process
group of a mesh axis (``Mesh.group(axis)``):

- ``allreduce``, ``replicated_sum``, ``device_put_sharded_batch`` and
  ``measure_allreduce_bandwidth`` (the reference's tools/bandwidth twin);
- ``bucketed_all_reduce``, the one flat-bucket packer
  (``MXTPU_ALLREDUCE_BUCKET_MB``) of the dist store's
  ``bucketed_pushpull`` and ``ShardedTrainer``'s dp gradient reduce;
- ``all_to_all``: gloo has no list ``all_to_all`` on CUDA tensors (the
  card's probe: "Backend gloo does not support alltoall"), so for a gloo
  group it is composed from ``all_to_all_single`` over one flat buffer:
  the one composed path.  Every other collective
  the port uses (``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single``) gloo accepts on CUDA
  tensors as they are (``probe``, run on the card by ``chip_smoke.py``);
- the differentiable regions a sharded step is written with (Megatron's
  f and g): ``copy_to_region`` (identity forward, all-reduce backward),
  ``reduce_from_region`` (all-reduce forward, identity backward) and
  ``gather_from_region`` (all-gather forward, this rank's slice
  backward);
- ``parallel_scope``, the state a sharded step runs its forward under:
  the dp group whose statistics are global (BatchNorm, the masked-token
  mean) and the tp group with the tensors that hold a tp shard, which the
  tp-aware ops (``ops.attention``'s trunk, ``Embedding``, the tied
  decoder) read by identity.

``mxnet_tpu/parallel/_compat.py`` (``shard_map``, ``pvary``) is JAX
plumbing for GSPMD's in-program collectives and has no counterpart here.
Every collective is guarded by ``MXTPU_COLLECTIVE_TIMEOUT``'s watchdog.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
import torch.distributed as dist

from .. import profiler, resilience
from .._parallel_scope import (ParallelScope, current_scope,  # noqa: F401
                               parallel_scope, stat_group)

#: the collectives' calls and bytes, and their seconds inside
#: ``timed_collectives`` (read by ``chip_smoke.py`` through ``dist_bert``)
_STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}
_SYNCED = [False]


def stats(reset=False):
    """Collective calls, bytes and (inside ``timed_collectives``) seconds
    since the last reset."""
    out = dict(_STATS)
    if reset:
        _STATS.update(calls=0, seconds=0.0, bytes=0)
    return out


@contextlib.contextmanager
def timed_collectives():
    """Count the collectives' own seconds in ``stats()``: inside the
    block each collective on a CUDA tensor synchronizes the card before
    its clock starts and after it stops.  Outside it no seconds are
    counted, since gloo's copy of a CUDA tensor to the host first waits
    for every kernel queued before it, and the host's clock around the
    call would count that compute as the collective's."""
    prev = _SYNCED[0]
    _SYNCED[0] = True
    try:
        yield
    finally:
        _SYNCED[0] = prev


@contextlib.contextmanager
def _timed(name, t):
    synced = _SYNCED[0]
    if synced and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    with resilience.guard_collective(name):
        yield
    if synced:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        _STATS["seconds"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += t.numel() * t.element_size()


def _size(group):
    return dist.get_world_size(group) if group is not None else 1


def all_reduce_(t, group, name="all_reduce"):
    """In-place sum over ``group`` (a no-op for no group)."""
    if group is None:
        return t
    with _timed(name, t):
        dist.all_reduce(t, group=group)
    return t


def bucket_bytes():
    """The byte budget of one flat bucket of ``bucketed_all_reduce``
    (``MXTPU_ALLREDUCE_BUCKET_MB``, default 4 MB)."""
    try:
        mb = float(os.environ.get("MXTPU_ALLREDUCE_BUCKET_MB", "4"))
    except ValueError:
        mb = 4.0
    return max(1, int(mb * 1024 * 1024))


def bucketed_all_reduce(tensors, group, name="bucket"):
    """Sum ``tensors`` over ``group`` with one all-reduce a flat bucket.

    Buckets fill per dtype in the tensors' order: a tensor joins the open
    bucket of its dtype while the bucket stays within ``bucket_bytes()``,
    else opens a new one.  Each bucket is packed into one flat buffer (a
    copy, also for a bucket of one tensor), reduced in place, and split
    back into views of the buffer.  With no group the buckets are packed
    and split alike, and nothing is reduced.  Returns (the reduced
    tensors in input order, [(flat buffer, the bucket's indices)]): the
    caller scales the buffers in place, or reads them whole (the store's
    gradient health)."""
    budget = bucket_bytes()
    buckets, fill = [], {}
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        cur = fill.get(t.dtype)
        if cur is None or cur[1] + nbytes > budget:
            cur = [[], 0]
            buckets.append(cur)
            fill[t.dtype] = cur
        cur[0].append(i)
        cur[1] += nbytes
    out, flats = [None] * len(tensors), []
    for idx, nbytes in buckets:
        with profiler.annotate("bucket_pack"):
            flat = torch.cat([tensors[i].reshape(-1) for i in idx]) \
                if len(idx) > 1 else tensors[idx[0]].reshape(-1).clone()
        if group is not None:
            with profiler.annotate("allreduce"):
                all_reduce_(flat, group, f"{name}[{flat.dtype} bucket, "
                                         f"{nbytes} bytes, {len(idx)} "
                                         "tensors]")
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
        flats.append((flat, idx))
    return out, flats


def all_gather_dim(t, group, dim=0):
    """Concatenate every rank's ``t`` along ``dim``, in group rank
    order."""
    if group is None:
        return t
    n = _size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with _timed("all_gather", out):
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(t, group, dim=0):
    """Sum ``t`` over ``group`` and keep this rank's block of ``dim``."""
    if group is None:
        return t
    n = _size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with _timed("reduce_scatter", src):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def broadcast_(t, src, group=None):
    with _timed("broadcast", t):
        dist.broadcast(t, src, group=group)
    return t


def all_to_all(outputs, inputs, group=None):
    """The list ``all_to_all``: ``inputs[j]`` goes to rank j, ``outputs[j]``
    comes from rank j (equal shapes).  NCCL runs it as it is; for gloo,
    which lacks it, it is composed from ``all_to_all_single`` over one
    flat buffer (the composed path)."""
    if dist.get_backend(group) != "gloo":
        with _timed("all_to_all", inputs[0]):
            dist.all_to_all(outputs, inputs, group=group)
        return outputs
    flat_in = torch.cat([x.reshape(-1) for x in inputs])
    flat_out = torch.empty_like(flat_in)
    with _timed("all_to_all", flat_in):
        dist.all_to_all_single(flat_out, flat_in, group=group)
    for o, piece in zip(outputs, flat_out.chunk(len(outputs))):
        o.copy_(piece.view_as(o))
    return outputs


def ppermute(t, perm, group, name="ppermute"):
    """The counterpart of ``lax.ppermute``: over ``group``, ``perm`` is a
    list of (source, destination) pairs of group ranks; this rank sends
    ``t`` to its destination and returns what its source sent (zeros
    shaped and typed as ``t`` when no pair names this rank as a
    destination).  Every rank of the group calls it with a tensor of the
    same shape and dtype.

    The exchange is one ``all_to_all_single`` whose chunk for the
    destination is ``t`` and whose other chunks are zeros: every rank
    posts its send and its receive in the one collective, so a ring
    cannot deadlock, and it runs on every backend and device (gloo's
    ``send``/``recv`` read a CUDA tensor's pointer as host memory:
    ``p2p_probe``).  Counted in ``stats()`` as the buffer a rank hands
    the backend, ``t`` times the group's size."""
    if group is None:
        return t
    me, n = dist.get_rank(group), _size(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: rank {me} appears twice in {perm}")
    flat = t.contiguous().reshape(-1)
    send = flat.new_zeros((n, flat.numel()))
    if dst:
        send[dst[0]] = flat
    recv = torch.empty_like(send)
    with _timed(name, send):
        dist.all_to_all_single(recv, send, group=group)
    return recv[src[0]].view_as(t) if src else torch.zeros_like(t)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        with _timed("all_to_all_single", x):
            dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def all_to_all_single(x, group):
    """Differentiable ``all_to_all_single`` over ``group``: dim 0 of ``x``
    is cut into the group's size of equal chunks, chunk j goes to rank j,
    and chunk j of the result came from rank j.  Its gradient is the same
    exchange of the gradient."""
    if group is None:
        return x
    return _AllToAll.apply(x, group)


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group, "global_sum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group,
                           "global_sum_grad"), None


def global_sum(x, group):
    """Sum ``x`` over ``group`` into a value every rank holds and feeds
    into its own loss: forward and backward are both sums over the group,
    so the trainer's mean over the ranks of their gradients is the
    gradient of the one global value."""
    return x if group is None else _SumShared.apply(x, group)


def probe(device, group=None):
    """Which collectives the group's backend accepts on tensors on
    ``device``: {name: "ok" | error text}.  Each is checked for its
    result too.  gloo's point-to-point reads a CUDA tensor's pointer as
    host memory, which kills the process rather than raising, so
    ``p2p_probe`` probes ``send``/``recv`` in rank processes of its
    own."""
    group = group if group is not None else dist.group.WORLD
    rank, n = dist.get_rank(group), _size(group)
    out = {}

    def t(name, fn):
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as exc:       # the probe reports, it never hides
            first = (str(exc).splitlines() or [""])[0]
            out[name] = f"{type(exc).__name__}: {first}"

    def all_reduce():
        x = torch.full((8,), float(rank + 1), device=device)
        dist.all_reduce(x, group=group)
        assert x[0].item() == n * (n + 1) / 2

    def broadcast():
        x = torch.full((8,), float(rank + 1), device=device)
        dist.broadcast(x, dist.get_global_rank(group, 0), group=group)
        assert x[0].item() == 1.0

    def gather():
        o = torch.empty(4 * n, device=device)
        dist.all_gather_into_tensor(
            o, torch.full((4,), float(rank), device=device), group=group)
        assert o[::4].tolist() == [float(r) for r in range(n)]

    def reduce_scatter():
        o = torch.empty(4, device=device)
        dist.reduce_scatter_tensor(
            o, torch.arange(4. * n, device=device), group=group)
        assert o[0].item() == n * 4 * rank

    def a2a_single():
        o = torch.empty(2 * n, device=device)
        dist.all_to_all_single(
            o, torch.arange(2. * n, device=device) + 100 * rank,
            group=group)
        assert o[0].item() == 2 * rank

    def a2a():
        outs = [torch.empty(2, device=device) for _ in range(n)]
        dist.all_to_all(outs, [torch.full((2,), float(rank), device=device)
                               for _ in range(n)], group=group)

    def p2p():
        x = torch.full((4,), float(rank), device=device)
        got = ppermute(x, [(r, (r + 1) % n) for r in range(n)], group)
        assert got[0].item() == float((rank - 1) % n)

    t("all_reduce", all_reduce)
    t("broadcast", broadcast)
    t("all_gather_into_tensor", gather)
    t("reduce_scatter_tensor", reduce_scatter)
    t("all_to_all_single", a2a_single)
    t("all_to_all", a2a)
    t("ppermute", p2p)
    return out


def p2p_probe(device_type="cuda", timeout=120.0):
    """Whether gloo's ``send``/``recv`` and ``batch_isend_irecv`` work on
    ``device_type`` tensors, learned in two rank processes of their own
    (``python -m mxnet_tpu_torch.parallel.collectives --p2p-probe``):
    {name: "ok" | error text | "process died (exit code N)"}.  A rank
    that dies (a host copy from a device pointer segfaults) or hangs past
    ``timeout`` is reported, not raised."""
    import json
    import socket
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[2])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % s.getsockname()[1]
    out = {}
    with tempfile.TemporaryDirectory(prefix="p2p_probe_") as tmp:
        procs = []
        for r in range(2):
            env = dict(os.environ, MXTPU_COORDINATOR=addr,
                       MXTPU_NUM_WORKERS="2", MXTPU_WORKER_RANK=str(r),
                       MXTPU_RENDEZVOUS_TIMEOUT=str(int(timeout)),
                       PYTHONPATH=root + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.parallel.collectives",
                 "--p2p-probe", device_type, tmp], cwd=root, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for name in ("send_recv", "batch_isend_irecv"):
            got = []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"{name}.{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        got.append(json.load(f))
                else:
                    got.append(f"process died (exit code {p.returncode})")
            out[name] = "ok" if all(g == "ok" for g in got) else \
                next(g for g in got if g != "ok")
    return out


def _p2p_probe_rank(device_type, outdir):
    import json

    from .. import distributed

    assert distributed.init_from_env()
    rank = dist.get_rank()
    device = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")

    def record(name, fn):
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res = "ok"
        except Exception as exc:       # the probe reports, it never hides
            first = (str(exc).splitlines() or [""])[0]
            res = f"{type(exc).__name__}: {first}"
        with open(os.path.join(outdir, f"{name}.{rank}.json"), "w") as f:
            json.dump(res, f)

    def send_recv():
        x = torch.full((4,), float(rank), device=device)
        y = torch.empty(4, device=device)
        if rank == 0:
            dist.send(x, 1)
            dist.recv(y, 1)
        else:
            dist.recv(y, 0)
            dist.send(x, 0)
        assert y[0].item() == float(1 - rank)

    def batched():
        x = torch.full((4,), float(rank), device=device)
        y = torch.empty(4, device=device)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                         dist.P2POp(dist.irecv, y,
                                                    1 - rank)]):
            w.wait()
        assert y[0].item() == float(1 - rank)

    record("send_recv", send_recv)
    record("batch_isend_irecv", batched)
    dist.destroy_process_group()


# -- the reference's eager helpers ---------------------------------------------

def _axis_group(mesh, axis):
    return None if mesh is None else mesh.group(axis)


def allreduce(x, mesh=None, axis="dp"):
    """Sum this rank's ``x`` over the ranks of ``mesh``'s ``axis`` (the
    whole process group without a mesh): the kvstore push+pull identity.
    Returns a new tensor; ``x`` is left as it was."""
    group = _axis_group(mesh, axis) if mesh is not None else (
        dist.group.WORLD if dist.is_initialized() else None)
    out = x.clone()
    return all_reduce_(out, group)


def replicated_sum(xs, mesh=None):
    """Sum a list of tensors that every rank holds alike: the sum of
    replicated values is replicated, so no rank talks to another."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x.to(out.device)
    return out


def device_put_sharded_batch(array, mesh, axis="dp"):
    """This rank's block of a global batch along dim 0 over ``mesh``'s
    ``axis``, on the rank's device (the JAX package's split of one global
    array).  A batch the axis does not divide raises."""
    t = torch.as_tensor(array)
    n, i = mesh.shape.get(axis, 1), mesh.coord(axis)
    if t.shape[0] % n:
        raise ValueError(f"device_put_sharded_batch: batch {t.shape[0]} "
                         f"not divisible by {axis}={n}")
    b = t.shape[0] // n
    return t[i * b:(i + 1) * b].to(mesh.device)


def measure_allreduce_bandwidth(mesh, size_mb=64, dtype="float32",
                                iters=10, axis="dp"):
    """Achieved all-reduce algorithmic bandwidth in GB/s over ``mesh``'s
    ``axis`` (a ring moves 2(p-1)/p of the data per rank)."""
    group = mesh.group(axis)
    p = mesh.shape.get(axis, 1)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    item = torch.empty((), dtype=dt).element_size()
    n = max(1, int(size_mb * (1 << 20) // item))
    x = torch.ones(n, dtype=dt, device=mesh.device)
    all_reduce_(x, group)                                   # warm-up
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda *a: None))
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce_(x, group)
    sync()
    dt_s = (time.perf_counter() - t0) / iters
    return 2 * (p - 1) / max(p, 1) * n * item / dt_s / 1e9


# -- differentiable regions ----------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, "tp_copy"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group, "tp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.n = dist.get_rank(group), _size(group)
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def copy_to_region(x, group):
    """Identity forward; the gradient is summed over ``group`` (the input
    of a column-parallel product, whose ranks each contribute a part)."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_region(x, group):
    """Sum over ``group`` forward; identity backward (the output of a
    row-parallel product)."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_region(x, group, dim=-1):
    """Concatenate every rank's ``x`` along ``dim``; backward keeps this
    rank's slice (every rank computes the same result downstream)."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim % x.dim())


# -- the sharded step's scope (``_parallel_scope``) -----------------------------

@contextlib.contextmanager
def sync_stats_scope():
    """Make BatchNorm statistics global over the whole process group
    (``SyncBatchNorm`` outside a sharded step); inside a sharded step the
    dp group already is."""
    if current_scope() is not None or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        yield
        return
    with parallel_scope(ParallelScope(dp_group=dist.group.WORLD)):
        yield


if __name__ == "__main__" and len(sys.argv) == 4 \
        and sys.argv[1] == "--p2p-probe":
    _p2p_probe_rank(sys.argv[2], sys.argv[3])
