"""The port's gang slice (``mxnet_tpu_torch/distributed.py``'s KV
transports, ``checkpoint.PeerSnapshotStore``, ``resilience.ElasticGang``
and its health plane) against the JAX package's.

- The KV transports round-trip and fence over ``FileKV``, ``TcpKV`` and
  ``CoordKV``; the TCP frame and the peer-snapshot frame are the JAX
  package's, so each package's client talks to the other's server.
- The failure detector (under a stepped clock), the straggler monitor,
  peer-snapshot retention and its fence, ``buddy_of`` and ``ScalePolicy``
  are fed the same inputs in both packages and give the same answers.
- Thread gangs of three ranks (a silent death, a planned drain, a
  scheduled admit, a partition's minority fenced and readmitted, a
  zombie evicted) train the reference tests' closed-form model through a
  KV all-reduce and land bitwise on its serial simulation.

Every heartbeat timeout that must confirm a death is at least 1 s, no
test asserts a wall-clock bound, and every thread is joined under a
limit, past which the test fails with the threads' stacks.
"""

import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import checkpoint as jcheckpoint
from mxnet_tpu import distributed as jdistributed
from mxnet_tpu import resilience as jresilience
from mxnet_tpu_torch import checkpoint, distributed, resilience, telemetry
from torch_one_thread import one_torch_thread  # noqa: F401

JOIN_LIMIT = 90.0


def _join_all(threads, limit=JOIN_LIMIT):
    """Join every thread within ``limit`` seconds in all; fail with the
    stacks of the ones still running."""
    deadline = time.monotonic() + limit
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        buf = io.StringIO()
        resilience.dump_thread_stacks(buf, reason="gang wedged")
        pytest.fail(f"threads {alive} still running after {limit}s:\n"
                    f"{buf.getvalue()}")


def _arm(spec):
    if spec is None:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
    else:
        os.environ["MXTPU_FAULT_INJECT"] = spec
    resilience.reset_faults()


@pytest.fixture
def faults():
    yield _arm
    _arm(None)


# -- the reference tests' closed-form model --------------------------------------

def _sim_losses(num_steps, phases, n=8):
    """``tests/test_elastic.py::_sim_losses``: the serial run of the gang
    model whose membership switches at each phase's start step (a
    reshape rolls back to the snapshot at the top of that step)."""
    w = np.full(n, 1.0, dtype=np.float64)
    losses = {}
    for step in range(num_steps):
        members = None
        for start, m in sorted(phases):
            if step >= start:
                members = m
        total = 0.0
        for r in sorted(members):
            total += float((r + 1) * float(w.sum()))
        loss = total / len(members)
        losses[step] = loss
        w = w * 0.99 - 0.01 * (loss / w.size)
    return losses, w


def _kv_allreduce(gang, kv, step, contribution):
    """The lockstep KV mean of the members' contributions."""
    epoch = gang.epoch
    kv.put_json(f"red/{epoch}/{step}/{gang.rank}",
                {"v": float(contribution)})
    gang.barrier(f"red{step}")
    total = 0.0
    for r in sorted(gang.members):
        total += float(kv.get_json(f"red/{epoch}/{step}/{r}")["v"])
    return total / len(gang.members)


def _train_step(state, loss):
    state["w"] = state["w"] * 0.99 - 0.01 * (loss / state["w"].size)
    state["opt"] += loss


# -- control plane units ---------------------------------------------------------

@pytest.fixture(params=["file", "tcp"])
def kv_backend(request, tmp_path):
    """(mode, make): ``make(rank)`` is a new client of one control plane,
    a FileKV directory or an in-process GangKVServer."""
    if request.param == "file":
        kvdir = str(tmp_path / "kv")

        def make(rank=None):
            return distributed.FileKV(kvdir, rank=rank)

        yield request.param, make
        return
    server = distributed.GangKVServer(lease_ttl=5.0).start()
    clients = []

    def make(rank=None):
        c = distributed.TcpKV(server.addr, rank=rank)
        clients.append(c)
        return c

    yield request.param, make
    for c in clients:
        c.close()
    server.stop()


def _roundtrip_and_fence(kv, other):
    kv.put_json("epoch/current", {"epoch": 3, "members": [0, 2]})
    assert kv.get_json("epoch/current") == {"epoch": 3, "members": [0, 2]}
    for r in range(3):
        kv.put_json(f"hb/{r}", {"rank": r, "seq": 1})
    kv.put_json("hb/sub/x", {"nested": True})
    assert [k for k, _ in kv.scan("hb")] == ["hb/0", "hb/1", "hb/2"]
    kv.delete("hb/1")
    kv.delete("hb/1")
    assert [k for k, _ in kv.scan("hb")] == ["hb/0", "hb/2"]
    assert kv.get("nope") is None and kv.get("nope", b"d") == b"d"
    with pytest.raises(ValueError):
        kv.put("a/../b", b"x")


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_kv_roundtrip_and_put_if_epoch_fence(kind, tmp_path):
    """Both transports: round trip, non-recursive sorted scan, idempotent
    delete; a write carrying an epoch older than the highest committed
    one is refused with ``FencedWrite``, equal and newer ones commit."""
    if kind == "file":
        kv = distributed.FileKV(str(tmp_path), rank=0)
        other = distributed.FileKV(str(tmp_path), rank=1)
        server = None
    else:
        server = distributed.GangKVServer(lease_ttl=5.0).start()
        kv = distributed.TcpKV(server.addr, rank=0)
        other = distributed.TcpKV(server.addr, rank=1)
    try:
        _roundtrip_and_fence(kv, other)
        kv.put_json_if_epoch("epoch/current", {"epoch": 2}, 2)
        other.put_json_if_epoch("epoch/current", {"epoch": 2, "b": 1}, 2)
        assert kv.committed_epoch() == 2
        with pytest.raises(distributed.FencedWrite):
            other.put_if_epoch("zombie/1", b"stale", 1)
        assert kv.get("zombie/1") is None
        kv.put_json_if_epoch("epoch/current", {"epoch": 5}, 5)
        assert other.committed_epoch() == 5
        assert other.get_json("epoch/current") == {"epoch": 5}
    finally:
        if server is not None:
            kv.close()
            other.close()
            server.stop()


def test_coordkv_over_the_process_group_store():
    """``CoordKV`` keeps the FileKV surface over a torch.distributed
    store: values under ``mxtpu_gang/``, scans from the appended index,
    deletes as tombstones (a read never blocks on a missing key)."""
    store = torch.distributed.HashStore()
    kv = distributed.CoordKV(store)
    _roundtrip_and_fence(kv, kv)
    assert store.check(["mxtpu_gang/hb/0"])
    # a second client of the same store sees the first one's keys
    kv2 = distributed.CoordKV(store)
    assert [k for k, _ in kv2.scan("hb")] == ["hb/0", "hb/2"]
    kv2.put_json("hb/1", {"back": 1})
    assert [k for k, _ in kv.scan("hb")] == ["hb/0", "hb/1", "hb/2"]


def test_gang_kv_selection(tmp_path, monkeypatch):
    for var in ("MXTPU_GANG_KV", "MXTPU_GANG_ADDR", "MXTPU_GANG_DIR",
                "MXTPU_WORKER_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.gang_kv() is None
    monkeypatch.setenv("MXTPU_GANG_DIR", str(tmp_path))
    assert isinstance(distributed.gang_kv(), distributed.FileKV)
    monkeypatch.setenv("MXTPU_GANG_KV", "tcp")
    with pytest.raises(resilience.MXNetError, match="GANG_ADDR"):
        distributed.gang_kv()
    server = distributed.GangKVServer().start()
    try:
        monkeypatch.setenv("MXTPU_GANG_ADDR", server.addr)
        kv = distributed.gang_kv()
        assert isinstance(kv, distributed.TcpKV)
        assert distributed.gang_kv() is kv       # one client a process
        kv.close()
    finally:
        server.stop()
    monkeypatch.setenv("MXTPU_GANG_KV", "nfs")
    with pytest.raises(resilience.MXNetError):
        distributed.gang_kv()


def test_tcp_kv_wire_compatible_with_the_jax_package():
    """The JAX package's TcpKV against the port's GangKVServer and the
    other way round: the same frames, the same answers, the fence."""
    pairs = ((distributed.GangKVServer, jdistributed.TcpKV,
              jdistributed.FencedWrite),
             (jdistributed.GangKVServer, distributed.TcpKV,
              distributed.FencedWrite))
    for server_cls, client_cls, fenced in pairs:
        server = server_cls(lease_ttl=5.0).start()
        a = client_cls(server.addr, rank=0)
        b = client_cls(server.addr, rank=1)
        try:
            a.put_json("hb/0", {"seq": 1})
            b.put("hb/1", b"raw")
            assert b.get_json("hb/0") == {"seq": 1}
            assert [k for k, _ in a.scan("hb")] == ["hb/0", "hb/1"]
            a.put_if_epoch("epoch/current", b"{}", 4)
            with pytest.raises(fenced):
                b.put_if_epoch("x", b"stale", 3)
            assert b.committed_epoch() == 4
            since = a.ping()
            b.put("hb/1", b"again")
            assert a.watch("hb/", since=since, timeout=2.0) > since
        finally:
            a.close()
            b.close()
            server.stop()


def test_peer_snapshot_frames_wire_compatible(tmp_path):
    """The ``MXTPSNP1`` frame of a numpy payload: the JAX package's store
    pushes into the port's and fetches back, and the other way round;
    both read one FileKV directory for the addresses."""
    kvdir = str(tmp_path / "kv")
    port = checkpoint.PeerSnapshotStore(
        0, kv=distributed.FileKV(kvdir)).start()
    ref = jcheckpoint.PeerSnapshotStore(
        1, kv=jdistributed.FileKV(kvdir)).start()
    rng = np.random.RandomState(0)
    a = {"w": rng.standard_normal(64).astype(np.float32), "step": 3,
         "opt": (np.arange(5, dtype=np.int64), 2.5)}
    b = {"w": rng.standard_normal(32).astype(np.float64)}
    try:
        assert ref.send_to(0, 4, a, epoch=1)
        assert port.held_steps(1) == [4]
        got = port.fetch(0, 1, 4)
        np.testing.assert_array_equal(got["w"], a["w"])
        assert got["step"] == 3 and got["opt"][1] == 2.5
        np.testing.assert_array_equal(got["opt"][0], a["opt"][0])
        got = ref.fetch(0, 1, 4)           # the reference reads the port
        np.testing.assert_array_equal(got["w"], a["w"])
        assert port.send_to(1, 6, b, epoch=1)
        assert ref.held_steps(0) == [6]
        np.testing.assert_array_equal(ref.fetch(1, 0, 6)["w"], b["w"])
        np.testing.assert_array_equal(port.fetch(1, 0, 6)["w"], b["w"])
        assert port.fetch(1, 0, 99) is None
        # a bf16 tensor goes over as its words and comes back bf16
        t = torch.randn(7).to(torch.bfloat16)
        assert port.send_to(1, 8, {"t": t})
        back = port.fetch(1, 0, 8)["t"]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), t.view(torch.int16))
        raw = ref.fetch(1, 0, 8)["t"]          # numpy words, no torch
        assert isinstance(raw["__mxt_bf16__"], np.ndarray)
    finally:
        port.close()
        ref.close()


def test_peer_snapshot_retention_epoch_filter_and_fence(tmp_path):
    """``keep`` steps a source (no time floor at ``retain_s=0``), the
    epoch-filtered advert, the receive fence and ``forget_rank``: the same
    steps held and advertised in both packages."""
    def run(ckpt, dist, kvdir):
        kv = dist.FileKV(kvdir)
        store = ckpt.PeerSnapshotStore(0, kv=kv, keep=2,
                                       retain_s=0.0).start()
        sender = ckpt.PeerSnapshotStore(1, kv=kv, keep=2,
                                        retain_s=0.0).start()
        out = []
        try:
            for step, epoch in ((2, 0), (4, 0), (6, 0), (8, 1)):
                sender.send_to(0, step, {"w": np.full(3, step)},
                               epoch=epoch)
                out.append((store.held_steps(1),
                            store.held_steps(1, epoch=0),
                            kv.get_json("held/0/1")))
            store.fence(2)
            store.fence(1)                       # never lowers
            assert sender.send_to(0, 10, {"w": np.zeros(3)}, epoch=1)
            out.append(store.held_steps(1))
            store.hold_own(12, {"w": np.ones(2)}, epoch=2)
            out.append((store.held_ranks(), store.held_steps(0)))
            store.prune_ranks([0])
            out.append((store.held_ranks(), kv.get_json("held/0/1")))
            return out
        finally:
            store.close()
            sender.close()

    assert run(checkpoint, distributed, str(tmp_path / "a")) == \
        run(jcheckpoint, jdistributed, str(tmp_path / "b"))


class _Clock:
    """``time`` with a stepped ``monotonic``."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_failure_detector_and_straggler_monitor_against_jax(tmp_path,
                                                            monkeypatch):
    """The same heartbeat history under a stepped clock: the two
    packages' detectors suspect and confirm the same peers at the same
    polls, and their straggler monitors name the same laggard."""
    def run(res, dist, kvdir):
        clock = _Clock()
        monkeypatch.setattr(res, "time", clock)
        kv = dist.FileKV(kvdir)
        pubs = {r: res.HeartbeatPublisher(kv, r) for r in (1, 2, 3)}
        det = res.FailureDetector(kv, 0, [0, 1, 2, 3], timeout=1.0,
                                  check_interval=0.05)
        mon = res.StragglerMonitor(det, window=3, share_threshold=0.5)
        out = []
        for tick in range(40):
            clock.now += 0.1
            for r, pub in pubs.items():
                if r == 2 and tick >= 10:
                    continue                    # rank 2 goes silent
                if r == 3 and tick % 3:
                    continue                    # rank 3 lags
                pub.note_step(tick if r != 3 else tick // 3)
                pub.publish_once()
            dead = det.poll()
            out.append((sorted(dead),
                        {p: h.suspected for p, h in det._peers.items()},
                        det.peer_steps(),
                        mon.observe(tick, 0.9 if tick > 20 else 0.1)))
        return out

    got = run(resilience, distributed, str(tmp_path / "a"))
    ref = run(jresilience, jdistributed, str(tmp_path / "b"))
    assert got == ref
    assert got[-1][0] == [2]
    assert any(o[3] is not None for o in got)


def test_buddy_ring_against_jax(tmp_path):
    kvs = (distributed.FileKV(str(tmp_path / "a")),
           jdistributed.FileKV(str(tmp_path / "b")))
    gangs = [res.ElasticGang(0, 4, kv=kv, peers=object())
             for res, kv in zip((resilience, jresilience), kvs)]
    for members in (None, [0, 2, 5], [3], [1, 4, 6, 7]):
        m = members or [0, 1, 2, 3]
        got = [[g.buddy_of(r, members) for r in m] for g in gangs]
        assert got[0] == got[1]
    assert gangs[0].buddy_of(3) == 0 and gangs[0].buddy_of(0) == 1


class _FakeGang:
    def __init__(self, kv, members):
        self.kv = kv
        self.rank = 0
        self.members = list(members)
        self.drain_margin = 2
        self.planned = []

    def plan_leave(self, at_step):
        self.planned.append(at_step)
        return at_step


def test_scale_policy_decisions_against_jax(tmp_path):
    """The same observations in both packages: the same grow requests
    (window, reset, data-bound refusal, max_world cap), the same drains
    and the min_world refusal."""
    def run(res, dist, kvdir):
        kv = dist.FileKV(kvdir)
        gang = _FakeGang(kv, (0, 1))
        pol = res.ScalePolicy(gang, window=3, cooldown=0.0, max_world=4)
        out = []
        feed = [(5.0, None), (0.0, None), (5.0, None), (5.0, None),
                (5.0, None), (5.0, 0.9), (5.0, None), (5.0, None),
                (5.0, None)]
        for step, (q, share) in enumerate(feed):
            out.append(pol.observe(step, queue_depth=q, data_share=share))
            req = kv.get_json("scale/req")
            out.append(None if req is None else
                       {k: v for k, v in req.items() if k != "t"})
        gang.members = [0, 1, 2, 3]
        kv.delete("scale/req")
        out.append([pol.observe(20 + s, queue_depth=9.0)
                    for s in range(4)])
        drain = res.ScalePolicy(gang, min_world=3)
        out.append((drain.on_preemption(7), list(gang.planned)))
        gang.members = [0, 1, 2]
        out.append((drain.on_preemption(11), drain.drains))
        rec = res.announce_freed_chips(kv, 2, step=9, count=4)
        out.append({k: v for k, v in rec.items() if k != "t"})
        return out

    got = run(resilience, distributed, str(tmp_path / "a"))
    assert got == run(jresilience, jdistributed, str(tmp_path / "b"))
    assert "grow" in got


# -- thread gangs --------------------------------------------------------------

def _gang(rank, world, kv, snap_every, timeout):
    return resilience.ElasticGang(rank, world, kv=kv,
                                  peer_snap_every=snap_every,
                                  heartbeat_interval=0.05,
                                  heartbeat_timeout=timeout)


def _adopt(info, rank):
    st = info.shards.get(rank)
    if st is None:                  # a joiner: any replica's weights
        st = dict(next(iter(info.shards.values())))
        st["opt"] = 0.0
    return {"w": np.array(st["w"], dtype=np.float64),
            "opt": float(st["opt"])}


def _run_rank(rank, world, kv_make, num_steps, snap_every, out, *,
              timeout=1.0, die_at=None, join=False, leave_after=None,
              step_s=0.0):
    kv = kv_make(rank)
    gang = _gang(rank, world, kv, snap_every, timeout)
    state = {"w": np.full(8, 1.0, dtype=np.float64), "opt": 0.0}
    step, losses, infos = 0, {}, []
    planned_at = None
    out[rank] = {"status": "started", "gang": gang}
    try:
        if join:
            info = gang.join()
            state = _adopt(info, rank)
            step = info.snap_step
            infos.append(info)
        else:
            gang.start()
        while step < num_steps:
            if die_at is not None and step == die_at:
                gang.hb.stop()              # silent death: no heartbeat
                out[rank] = {"status": "died", "losses": losses,
                             "gang": gang}
                return
            if leave_after is not None and step == leave_after \
                    and planned_at is None:
                planned_at = gang.plan_leave(step + gang.drain_margin)
            try:
                gang.step_tick(step, state=state)
                loss = _kv_allreduce(gang, kv, step,
                                     (rank + 1) * float(state["w"].sum()))
            except resilience.RankFailure as rf:
                try:
                    info = gang.recover(rf)
                except resilience.GangEvicted:
                    out[rank] = {"status": "evicted", "losses": losses,
                                 "gang": gang, "at": step}
                    return
                state = _adopt(info, rank)
                step = info.snap_step
                infos.append(info)
                continue
            except resilience.GangEvicted:
                # the others committed the epoch that leaves this rank
                # out before its own tick of the drain step: a planned
                # leaver's exit when it runs behind
                out[rank] = {"status": "evicted", "losses": losses,
                             "gang": gang, "at": step}
                return
            losses[step] = loss
            _train_step(state, loss)
            step += 1
            if step_s:
                time.sleep(step_s)
        out[rank] = {"status": "done", "losses": losses, "gang": gang,
                     "infos": infos, "w": state["w"]}
    except Exception as e:                  # noqa: BLE001 — surfaced
        out[rank] = {"status": "error", "error": repr(e), "gang": gang}


def _start(target, ranks, *args, kwargs_of=None):
    kwargs_of = kwargs_of or {}
    threads = [threading.Thread(target=target, name=f"rank{r}",
                                args=(r,) + args,
                                kwargs=kwargs_of.get(r, {}))
               for r in ranks]
    for t in threads:
        t.start()
    return threads


def _stop_all(out):
    for res in out.values():
        res["gang"].stop()


def test_thread_gang_survives_silent_death_tcp(tmp_path):
    """Rank 1 goes silent at step 6 (timeout 1 s) over a GangKVServer: the
    survivors reshape to [0, 2] from the newest common peer snapshot (step
    4: the buddy's copy of the dead rank lags a round) and land bitwise on
    the serial run that switches membership there."""
    server = distributed.GangKVServer(lease_ttl=5.0).start()
    clients = []

    def make(rank):
        c = distributed.TcpKV(server.addr, rank=rank)
        clients.append(c)
        return c

    out = {}
    threads = _start(_run_rank, range(3), 3, make, 10, 2, out,
                     kwargs_of={1: {"die_at": 6}})
    try:
        _join_all(threads)
        assert out[1]["status"] == "died"
        sim, sim_w = _sim_losses(10, [(0, [0, 1, 2]), (4, [0, 2])])
        for r in (0, 2):
            assert out[r]["status"] == "done", out[r]
            (info,) = out[r]["infos"]
            assert (info.source, info.snap_step, info.members, info.epoch,
                    info.dead) == ("peer", 4, [0, 2], 1, [1])
            assert out[r]["losses"] == sim
            np.testing.assert_array_equal(out[r]["w"], sim_w)
        for s in range(4):
            assert out[1]["losses"][s] == sim[s]
    finally:
        _stop_all(out)
        for c in clients:
            c.close()
        server.stop()


def test_thread_gang_planned_drain_zero_lost_steps(tmp_path, monkeypatch):
    """Rank 1 announces at step 4 that it leaves at step 6: every member
    snapshots at exactly step 6 and reshapes with no detection window; the
    leaver computed 6 losses, none rolled back, and the survivors follow
    the serial run bitwise."""
    ev = tmp_path / "ev.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY_PATH", str(ev))
    telemetry.reset()
    kvdir = str(tmp_path / "kv")
    out = {}
    threads = _start(_run_rank, range(3), 3,
                     lambda r: distributed.FileKV(kvdir, rank=r), 10, 2,
                     out, kwargs_of={r: {"timeout": 2.0, "leave_after":
                                         4 if r == 1 else None}
                                     for r in range(3)})
    try:
        _join_all(threads)
        assert out[1]["status"] == "evicted", out[1]
        sim, sim_w = _sim_losses(10, [(0, [0, 1, 2]), (6, [0, 2])])
        for r in (0, 2):
            assert out[r]["status"] == "done", out[r]
            (info,) = out[r]["infos"]
            assert (info.planned, info.snap_step, info.members,
                    info.source) == (True, 6, [0, 2], "peer")
            assert out[r]["losses"] == sim
            np.testing.assert_array_equal(out[r]["w"], sim_w)
        assert sorted(out[1]["losses"]) == list(range(6))
        for s in range(6):
            assert out[1]["losses"][s] == sim[s]
    finally:
        _stop_all(out)
        telemetry.reset()
    kinds = [r.get("event") for r in telemetry.tail_records(str(ev))]
    for kind in ("gang_drain_scheduled", "rank_drained", "mesh_reshape",
                 "elastic_recover"):
        assert kind in kinds, kind


def test_thread_gang_scheduled_admit_zero_lost_steps_tcp():
    """A rank that asks to join mid-run is admitted at a scheduled step:
    the running ranks never roll back, and all three end bitwise on the
    serial run that adds it there."""
    server = distributed.GangKVServer(lease_ttl=5.0).start()
    clients = []

    def make(rank):
        c = distributed.TcpKV(server.addr, rank=rank)
        clients.append(c)
        return c

    out = {}
    threads = _start(_run_rank, range(2), 2, make, 12, 2, out,
                     kwargs_of={r: {"timeout": 2.0, "step_s": 0.08}
                                for r in range(2)})
    time.sleep(0.2)
    threads += _start(_run_rank, [2], 2, make, 12, 2, out,
                      kwargs_of={2: {"timeout": 2.0, "step_s": 0.08,
                                     "join": True}})
    try:
        _join_all(threads)
        for r in range(3):
            assert out[r]["status"] == "done", out.get(r)
        info0 = out[0]["infos"][0]
        assert info0.members == [0, 1, 2] and info0.planned is True
        sim, sim_w = _sim_losses(12, [(0, [0, 1]),
                                      (info0.snap_step, [0, 1, 2])])
        for r in range(3):
            for s, v in out[r]["losses"].items():
                assert v == sim[s], (r, s)
            np.testing.assert_array_equal(out[r]["w"], sim_w)
        for r in (0, 1):
            assert sorted(out[r]["losses"]) == list(range(12))
    finally:
        _stop_all(out)
        for c in clients:
            c.close()
        server.stop()


def _run_partition_rank(rank, world, kv_make, num_steps, snap_every, out,
                        step_s=0.05):
    """A rank of the partition case: cut off, it waits for the heal and
    the majority's next epoch, probes the fence with a stale-epoch write
    (which must be refused) and rejoins through ``park_fenced``."""
    kv = kv_make(rank)
    gang = _gang(rank, world, kv, snap_every, 1.0)
    gang.start()
    state = {"w": np.full(8, 1.0, dtype=np.float64), "opt": 0.0}
    step, losses, infos = 0, {}, []
    rec = {"fenced": False, "rejoined": False, "probe_rejected": 0,
           "probe_committed": 0}
    out[rank] = {"status": "started", "gang": gang}
    try:
        while step < num_steps:
            try:
                gang.step_tick(step, state=state)
                loss = _kv_allreduce(gang, kv, step,
                                     (rank + 1) * float(state["w"].sum()))
            except (resilience.GangFenced, distributed.GangKVError):
                rec["fenced"] = True
                stale = gang.epoch
                t0 = time.monotonic()
                while time.monotonic() - t0 < 30:
                    try:
                        cur = kv.get_json("epoch/current")
                        if cur and int(cur.get("epoch", 0)) > stale:
                            break
                    except Exception:   # noqa: BLE001 — still cut off
                        pass
                    time.sleep(0.05)
                try:
                    kv.put_if_epoch(f"zombie/{rank}", b"stale", stale)
                    rec["probe_committed"] += 1
                except distributed.FencedWrite:
                    rec["probe_rejected"] += 1
                info = gang.park_fenced(timeout=30.0)
                rec["rejoined"] = True
                if info is not None:
                    state = _adopt(info, rank)
                    step = info.snap_step
                    infos.append(info)
                continue
            except resilience.RankFailure as rf:
                info = gang.recover(rf)
                state = _adopt(info, rank)
                step = info.snap_step
                infos.append(info)
                continue
            losses[step] = loss
            _train_step(state, loss)
            time.sleep(step_s)
            step += 1
        out[rank] = dict(rec, status="done", losses=losses, gang=gang,
                         infos=infos, w=state["w"])
    except Exception as e:                  # noqa: BLE001 — surfaced
        out[rank] = {"status": "error", "error": repr(e), "gang": gang}


def test_thread_gang_partition_minority_fenced_and_readmitted(
        tmp_path, faults, monkeypatch):
    """Rank 2 is cut off from the gang directory for 3 s (a death is
    confirmed after 1 s of silence): the majority commits the next epoch
    and goes on bitwise; the minority is fenced, its stale-epoch probe
    refused, and after the heal it is readmitted, so the world ends at
    [0, 1, 2], every rank on the serial run of the membership rank 0
    lived."""
    monkeypatch.setenv("MXTPU_PARTITION_SECS", "3.0")
    kvdir = str(tmp_path / "kv")
    out = {}
    threads = _start(_run_partition_rank, range(3), 3,
                     lambda r: distributed.FileKV(kvdir, rank=r), 60, 2,
                     out)
    time.sleep(0.8)                     # the gang runs, snapshots exist
    faults("partition_split:2")
    try:
        _join_all(threads)
        for r in range(3):
            assert out[r]["status"] == "done", out[r]
        assert out[2]["fenced"] and out[2]["rejoined"], out[2]
        assert out[2]["probe_committed"] == 0
        assert out[2]["probe_rejected"] >= 1
        for r in range(3):
            assert sorted(out[r]["gang"].members) == [0, 1, 2]
        infos0 = out[0]["infos"]
        assert len(infos0) >= 2 and infos0[0].members == [0, 1]
        phases = [(0, [0, 1, 2])] + [(i.snap_step, list(i.members))
                                     for i in infos0]
        sim, sim_w = _sim_losses(60, phases)
        for r in (0, 1):
            assert out[r]["losses"] == sim, f"rank {r} diverged"
        for r in range(3):
            np.testing.assert_array_equal(out[r]["w"], sim_w)
    finally:
        _stop_all(out)


def test_zombie_rank_evicted_before_any_durable_write(kv_backend):
    """A newer epoch that excludes this rank committed while it was away:
    its next tick raises ``GangEvicted`` from the epoch check, before the
    periodic snapshot, and even a direct snapshot is fenced into
    eviction, so its advert is never refreshed."""
    _, make = kv_backend
    kv = make(rank=0)
    gang = _gang(0, 1, kv, 1, 5.0)
    gang.start()
    try:
        state = {"w": np.ones(4), "opt": 0.0}
        gang.step_tick(0, state=state)
        assert kv.get_json("snap/0")["step"] == 0
        other = make(rank=1)
        other.put_json_if_epoch(
            "epoch/current", {"epoch": 5, "members": [1], "dead": [0]}, 5)
        with pytest.raises(resilience.GangEvicted):
            gang.step_tick(1, state=state)
        assert kv.get_json("snap/0")["step"] == 0
        with pytest.raises(resilience.GangEvicted):
            gang.snapshot(1, state)
        assert kv.get_json("snap/0")["step"] == 0
    finally:
        gang.stop()


def test_run_resilient_with_a_gang_reshapes_instead_of_restarting(
        tmp_path, monkeypatch):
    """``run_resilient(gang=, on_reshape=)`` (on the main thread, which
    its SIGTERM handler needs) trains the closed-form model with a thread
    rank; the thread rank goes silent at step 5; the tick raises
    ``RankFailure``, the gang reshapes from peer RAM, ``on_reshape`` adopts
    the shard and the run ends on the serial trajectory.  One survivor of
    two is no strict majority, so the gang runs with ``MXTPU_QUORUM=0``."""
    monkeypatch.setenv("MXTPU_QUORUM", "0")
    kvdir = str(tmp_path / "kv")
    out = {}
    peer = threading.Thread(
        target=_run_rank, name="rank1",
        args=(1, 2, lambda r: distributed.FileKV(kvdir, rank=r), 10, 2,
              out), kwargs={"die_at": 5})
    kv = distributed.FileKV(kvdir, rank=0)
    gang = _gang(0, 2, kv, 2, 1.0)
    gang.start()
    peer.start()
    state = {"w": np.full(8, 1.0, dtype=np.float64), "opt": 0.0}
    infos = []

    def step_fn(step):
        loss = _kv_allreduce(gang, kv, step, float(state["w"].sum()))
        _train_step(state, loss)
        return loss

    def set_state(s):
        state.update(w=np.array(s["w"]), opt=float(s["opt"]))

    def on_reshape(info):
        infos.append(info)
        state.update(_adopt(info, 0))
        return info.snap_step

    try:
        report = resilience.run_resilient(
            step_fn, resilience.LocalCheckpointer(str(tmp_path / "ck")),
            10, get_state=lambda: dict(state), set_state=set_state,
            checkpoint_every=0, gang=gang, on_reshape=on_reshape)
        _join_all([peer])
        assert out[1]["status"] == "died", out[1]
        (info,) = infos
        assert (info.source, info.members, info.snap_step) == \
            ("peer", [0], 4)
        assert report.reshapes == 1 and report.final_step == 10
        sim, sim_w = _sim_losses(10, [(0, [0, 1]), (4, [0])])
        assert report.losses == sim
        np.testing.assert_array_equal(state["w"], sim_w)
    finally:
        gang.stop()
        _stop_all(out)


def test_gang_bert_tool_two_processes_recover_from_peer_ram(tmp_path):
    """The two-process case of ``tools/gang_bert.py`` on the host with
    ``bert_tiny``: each rank trains on its own batches, its gradients
    summed over the process group.  Rank 1 is SIGKILLed after its step 9;
    rank 0 confirms the death (heartbeat timeout 1 s), recovers from peer
    RAM with no restore from disk, forms its group again (one member: no
    group) and resumes from the common snapshot, whose step it reruns
    bitwise as it ran the first time; the replicas' weights were equal at
    every step up to the kill."""
    from mxnet_tpu_torch.tools import gang_bert

    out = gang_bert.drive(str(tmp_path), model="tiny", cpu=True, batch=4,
                          seq=32, steps=28, hb_timeout=1.0, min_step_s=0.15,
                          timeout=240)
    r0 = out[0]
    (rec,) = r0["recoveries"]
    assert (rec["source"], rec["members"], rec["dead"]) == \
        ("peer", [0], [1])
    assert r0["disk_restores"] == 0
    assert r0["report"]["final_step"] == 28
    assert [(g["epoch"], g["world"]) for g in r0["groups"]] == \
        [(0, 2), (rec["epoch"], 1)]
    assert rec["detect_t"] >= out["kill_t"] and out["fetch"]["leaves"] > 0
    first = {x["step"]: x for x in r0["losses"] if x["epoch"] == 0}
    replayed = [x for x in r0["losses"] if x["epoch"] == rec["epoch"]]
    k = rec["snap_step"]
    assert k % 4 == 0 and replayed[0]["step"] == k
    assert replayed[0]["loss"] == first[k]["loss"]
    for line in out["doomed_lines"]:
        if line["step"] in first:
            assert line["fingerprint"] == \
                first[line["step"]]["fingerprint"], line["step"]
            assert line["loss"] != first[line["step"]]["loss"]


def _jax_mlp_run(steps, world, batch):
    """The JAX ``gluon.Trainer`` on the gang's global batch (every rank's
    batch of a step, concatenated): the MLP's weights after each step."""
    import mxnet_tpu as jmx
    from mxnet_tpu_torch.tools import gang_bert

    nn = jmx.gluon.nn
    net = nn.HybridSequential(prefix="gm_")
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu", in_units=gang_bert.MLP_IN),
                nn.Dense(gang_bert.MLP_OUT, in_units=32))
    net.initialize()
    params = net.collect_params()
    for k, v in gang_bert.mlp_params().items():
        params[net.prefix + k].set_data(v)
    tr = jmx.gluon.Trainer(params, "sgd", dict(gang_bert.MLP_SGD))
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for step in range(steps):
        xs, ys = zip(*(gang_bert.mlp_batch(step, r, batch)
                       for r in range(world)))
        with jmx.autograd.record():
            loss = loss_fn(net(jmx.nd.array(np.concatenate(xs))),
                           jmx.nd.array(np.concatenate(ys)))
        loss.backward()
        tr.step(batch)      # each rank's trainer rescales by its batch
        out.append({k[len(net.prefix):]: p.data().asnumpy()
                    for k, p in params.items()})
    return out


def test_gang_three_ranks_all_reduce_through_a_reformed_group(tmp_path):
    """Three rank processes of ``tools/gang_bert.py --model mlp``, each on
    its own batches, sum their gradients over the gang's process group;
    rank 2 is SIGKILLed after its step 9.  The survivors turn the broken
    collective into a ``RankFailure``, recover from peer RAM, form a gloo
    group of two over the gang's KV (epoch 1's prefix) and train on.
    Before the reshape every step's weights match the JAX
    ``gluon.Trainer`` on the concatenated global batch (rtol 2e-3 / atol
    2e-4); the survivors' weights are equal at every step; after the
    reshape the survivors' run is bitwise a clean two-rank gang's started
    from the same snapshot."""
    from mxnet_tpu_torch.tools import gang_bert

    batch, steps = 4, 16
    gdir, cdir = tmp_path / "gang", tmp_path / "clean"
    gdir.mkdir()
    cdir.mkdir()
    # a 2 s heartbeat timeout: five processes share the host's cores
    # with the other test workers
    out = gang_bert.drive(str(gdir), world=3, kill_rank=2, kill_after=9,
                          model="mlp", cpu=True, batch=batch, steps=steps,
                          hb_timeout=2.0, min_step_s=0.1, timeout=240)
    ranks = [out[0], out[1]]
    epochs = set()
    for r, res in enumerate(ranks):
        (rec,) = res["recoveries"]
        assert (rec["source"], rec["members"], rec["dead"]) == \
            ("peer", [0, 1], [2])
        assert res["report"]["final_step"] == steps
        assert [(g["epoch"], g["world"], g["place"], g["backend"])
                for g in res["groups"]] == \
            [(0, 3, r, "gloo"), (rec["epoch"], 2, r, "gloo")]
        epochs.add((rec["epoch"], rec["snap_step"]))
    ((epoch, k),) = epochs
    by = [{(x["epoch"], x["step"]): x for x in res["losses"]}
          for res in ranks]
    for key in set(by[0]) & set(by[1]):
        assert by[0][key]["fingerprint"] == by[1][key]["fingerprint"], key
    pre = sorted(s for e, s in by[0] if e == 0)
    want = _jax_mlp_run(pre[-1] + 1, 3, batch)
    for s in pre:
        for name, w in want[s].items():
            np.testing.assert_allclose(by[0][(0, s)]["params"][name], w,
                                       rtol=2e-3, atol=2e-4,
                                       err_msg=f"{name} at step {s}")
    clean = gang_bert.drive(
        str(cdir), world=2, kill_rank=None, model="mlp", cpu=True,
        batch=batch, steps=steps, hb_timeout=2.0, timeout=240,
        start_state=str(gdir / "rank0.json.restored.pkl"))
    for r in range(2):
        runs = [x for x in clean[r]["losses"]]
        assert runs[0]["step"] == k and len(runs) == steps - k
        for x in runs:
            got = by[r][(epoch, x["step"])]
            assert got["loss"] == x["loss"], x["step"]
            assert got["params"] == x["params"], x["step"]


def test_snapshot_in_flight_across_a_reshape_is_dropped(tmp_path):
    """With an ``AsyncCheckpointer`` holding the gang's store
    (``attach_peers``) the snapshot's hold, send and advert run on the
    writer thread.  One still in flight when the gang commits a newer
    epoch is dropped quietly: no error reaches a later step, and the next
    snapshot advertises under the new epoch."""
    kv = distributed.FileKV(str(tmp_path / "kv"), rank=0)
    store = checkpoint.PeerSnapshotStore(0, kv=kv, retain_s=60.0)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path / "ck"), rank=0,
                                      world_size=1)
    ck.attach_peers(store, every=1)
    gang = resilience.ElasticGang(0, 1, kv=kv, peers=store,
                                  checkpointer=ck, peer_snap_every=1,
                                  heartbeat_interval=0.05,
                                  heartbeat_timeout=5.0)
    gang.start()
    gate = threading.Event()
    real = store.hold_blob

    def slow_hold(*args, **kwargs):
        gate.wait(30)
        real(*args, **kwargs)

    try:
        store.hold_blob = slow_hold
        gang.step_tick(0, state={"w": np.ones(3)})      # in flight
        kv.put_json_if_epoch("epoch/current",
                             {"epoch": 1, "members": [0], "dead": [],
                              "joined": []}, 1)
        gang.epoch = 1
        gate.set()
        ck.wait()                       # nothing carried over
        store.hold_blob = real
        gang.step_tick(1, state={"w": np.full(3, 2.0)})
        ck.wait()
        assert kv.get_json("snap/0") == {"step": 1, "steps": [1],
                                         "epoch": 1}
        np.testing.assert_array_equal(store.own_at(1)["w"], np.full(3, 2.0))
    finally:
        gate.set()
        gang.stop()
