"""One rank of a BERT-base elastic gang: a whole replica trained under
``run_resilient(gang=...)``, peer snapshots in the buddy's RAM, recovery
from peer RAM when a rank dies.

    python3 -m mxnet_tpu_torch.tools.gang_bert --rank R --world N
        --addr HOST:PORT --out PATH [--steps 28] [--snap-every 4]
        [--batch 32] [--seq 512] [--model base|tiny] [--cpu]
        [--hb-timeout 2.0] [--retain-s 30] [--trace-step S]
        [--min-step-s 0]

``--addr`` is a running ``distributed.GangKVServer``; the rank's
checkpoints go beside ``--out``.  Every rank builds
``bench_bert``'s model (BERT-base, bf16, flash trunk, AdamW on f32
masters through ``gluon.Trainer.train_step``; ``--model tiny`` is
``bert_tiny`` in f32 for the host) from the same seed and trains on the
same batches (step s draws its batch and its dropout from seed + s), so
the replicas stay bitwise equal, as data-parallel replicas are after
their all-reduce (the replicas' all-reduce through a process group
formed again after a reshape waits for the next multi-GPU slice,
ROADMAP queue 1 item 1b).  The gang snapshots every ``--snap-every`` steps through an
``AsyncCheckpointer`` with a ``PeerSnapshotStore`` attached: the state is
copied off the card into pinned memory and the writer thread keeps it
and sends it to the buddy.  A two-rank gang loses its majority with one
death, so the tool runs with ``MXTPU_QUORUM=0``.

The rank writes JSON lines to stdout as it goes, one a step (``{"step",
"t", "loss", "held", ...}``), and at the end one result to ``--out``:
every loss in the order run, the recoveries (epoch, members, source,
snapshot step, ``recovery_ms``, the wall time of the detection and of
the first step after the reshape), the disk restores, the peer store's
pack, send and fetch times, the train-stream stall of the snapshot
steps (the host call and the pinned copy it orders, apart from the wait
for the previous snapshot's writer), the median host us of a
``step_tick`` on other steps, apart by whether a snapshot's writer was
running, the median us of one KV round trip (``ping``), the flash
wrappers' launches and, with ``--trace-step``,
the kernels of that step counted from a fenced trace (card only).
``--min-step-s`` pads each step to that many seconds, so a rehearsal on
the host with a tiny model still outlasts the heartbeat timeout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

SEED = 0


def _build(model, batch, seq, device, dropout):
    """(net, trainer, loss_fn, vocab) for ``model``."""
    from .. import gluon
    from ..gluon.model_zoo import bert
    from ..initializer import Xavier
    from . import bench_bert

    if model == "base":
        net, tr, loss_fn, _tok, _lab = bench_bert.build_gluon(
            batch, seq, "flash", "bfloat16", device, seed=SEED,
            dropout=dropout)
        return net, tr, loss_fn, net._vocab
    net = bert.bert_tiny(dropout=dropout, max_length=seq, scan_layers=True,
                         attention_impl="flash", device=device)
    net.initialize(init=Xavier(), generator=torch.Generator(
        device=net.word_embed_weight.data()._data.device).manual_seed(SEED))
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adamw",
                       dict(bench_bert.GLUON_ADAMW))
    return net, tr, bert.BERTPretrainLoss(), net._vocab


def _batch(step, batch, seq, vocab, dev):
    """Step ``step``'s batch, the same on every rank and every replay."""
    from .. import context
    from ..ndarray.ndarray import NDArray
    from . import bench_bert

    tok, mlm, nsp = bench_bert.make_data(batch, seq, vocab, dev,
                                         seed=SEED + 1 + step)
    ctx = context.context_of(dev)
    return NDArray(tok, ctx), (NDArray(mlm, ctx), NDArray(nsp, ctx))


def _emit(obj):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def run(rank, world, addr, out, steps=28, snap_every=4, batch=32,
        seq=512, model="base", device=None, hb_timeout=2.0, retain_s=30.0,
        trace_step=None, dropout=0.1, min_step_s=0.0):
    """Train this rank to ``steps`` and write the result to ``out``."""
    from .. import checkpoint, distributed, resilience, telemetry
    from .. import context
    from .. import random as mxrandom
    from ..ops import flash_attention as fa

    os.environ["MXTPU_QUORUM"] = "0"
    dev = context.resolve(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    telemetry.reset()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
    net, tr, loss_fn, vocab = _build(model, batch, seq, dev, dropout)
    kv = distributed.TcpKV(addr, rank=rank)
    store = checkpoint.PeerSnapshotStore(rank, kv=kv, retain_s=retain_s)
    ckdir = os.path.join(os.path.dirname(os.path.abspath(out)),
                         f"ckpt_rank{rank}")
    ck = checkpoint.AsyncCheckpointer(ckdir, max_to_keep=1, rank=0,
                                      world_size=1)
    ck.attach_peers(store, every=snap_every)
    gang = resilience.ElasticGang(
        rank, world, kv=kv, peers=store, checkpointer=ck,
        peer_snap_every=snap_every, heartbeat_interval=hb_timeout / 8,
        heartbeat_timeout=hb_timeout)
    gang.start()
    gang.barrier("start")

    losses, stalls, infos = [], [], []
    ticks_us = {False: [], True: []}    # by whether a snapshot is in flight
    marks = {"reshaped": None}
    kernels = {}

    def tick_timed(step, state_fn=None, **kw):
        """``step_tick`` with the snapshot steps' stall read: the card
        idle before, the train stream drained after (it waits on the
        pinned copy), the wait for the previous writer apart."""
        snap = snap_every and step % snap_every == 0 and \
            step != gang._last_snap_step
        if snap and on_card:
            torch.cuda.synchronize(dev)
        busy = ck.in_flight()
        t0 = time.perf_counter()
        try:
            real_tick(step, state_fn=state_fn, **kw)
        finally:
            if snap:
                if on_card:
                    torch.cuda.current_stream(dev).synchronize()
                total = (time.perf_counter() - t0) * 1e3
                st = ck.peer_stats
                stalls.append({"step": step, "total_ms": total,
                               "join_ms": st.get("join_ms"),
                               "stall_ms": total - st.get("join_ms", 0.0)})
            else:
                ticks_us[busy].append((time.perf_counter() - t0) * 1e6)

    real_tick = gang.step_tick
    gang.step_tick = tick_timed

    def step_fn(step):
        t_start = time.perf_counter()
        mxrandom.seed(SEED + 1000 + step)
        tok, labels = _batch(step, batch, seq, vocab, dev)

        def one():
            return tr.train_step(net, loss_fn, tok, labels)

        if trace_step is not None and step == trace_step and on_card:
            from ..tools.trace_edges import kernel_records

            box = []
            events = kernel_records(lambda: box.append(one()))
            loss = box[0]
            for name in ("flash_fwd", "flash_dq", "flash_dkv"):
                kernels[name] = sum(1 for e in events
                                    if name in e.name.lower())
        else:
            loss = one()
        value = loss._data.detach().float().cpu().reshape(-1).tolist()
        left = min_step_s - (time.perf_counter() - t_start)
        if left > 0:
            time.sleep(left)
        t = time.time()
        losses.append((step, value))
        if marks["reshaped"] is not None and "first_step_t" not in \
                marks:
            marks["first_step_t"] = t
        _emit({"rank": rank, "step": step, "t": t, "loss": value,
               "held": store.held_steps(rank),
               "held_from": {str(r): store.held_steps(r)
                             for r in store.held_ranks() if r != rank},
               "stats": dict(store.stats)})
        return sum(value)

    def on_reshape(info):
        marks["reshaped"] = time.time()
        infos.append({"epoch": info.epoch, "members": info.members,
                      "source": info.source, "snap_step": info.snap_step,
                      "dead": info.dead, "recovery_ms": info.recovery_ms,
                      "detect_t": marks["reshaped"]
                      - info.recovery_ms / 1e3,
                      "reshaped_t": marks["reshaped"]})
        checkpoint.load_trainer_state(tr, info.shards[rank])
        return info.snap_step

    report = resilience.run_resilient(
        step_fn, ck, steps,
        get_state=lambda: checkpoint.trainer_state(tr, copy=False),
        set_state=lambda s: checkpoint.load_trainer_state(tr, s),
        checkpoint_every=0, gang=gang, on_reshape=on_reshape,
        max_restarts=0)
    if "first_step_t" in marks and infos:
        infos[-1]["first_step_t"] = marks["first_step_t"]
    rtts = []
    for _ in range(200):
        t_ping = time.perf_counter()
        kv.ping()
        rtts.append((time.perf_counter() - t_ping) * 1e6)
    counters = telemetry.REGISTRY.snapshot()
    result = {
        "rank": rank, "world": world, "steps": steps, "model": model,
        "batch": batch, "seq": seq, "device": str(dev),
        "losses": losses, "recoveries": infos,
        "report": {"final_step": report.final_step,
                   "reshapes": report.reshapes,
                   "resumed_from": report.resumed_from},
        "disk_restores": counters.get("elastic.disk_restores", 0),
        "store": dict(store.stats),
        "snapshot_stalls": stalls,
        "step_tick_us_median": {
            "writer_idle": statistics.median(ticks_us[False])
            if ticks_us[False] else None,
            "writer_busy": statistics.median(ticks_us[True])
            if ticks_us[True] else None,
            "ticks": [len(ticks_us[False]), len(ticks_us[True])]},
        "kv_round_trip_us_median": statistics.median(rtts),
        "launches": {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                     "flash_attention_dq": fa.flash_attention_dq.launches,
                     "flash_attention_dkv":
                         fa.flash_attention_dkv.launches},
        "kernels_traced_step": kernels,
        "members": gang.members, "epoch": gang.epoch,
    }
    with open(out, "w") as f:
        json.dump(result, f)
    gang.stop()
    kv.close()
    return result


_SERVE = """
import sys
from mxnet_tpu_torch.distributed import GangKVServer
host, port = sys.argv[1].rsplit(":", 1)
server = GangKVServer(host, int(port)).start()
sys.stdin.read()
server.stop()
"""


def drive(workdir, world=2, kill_rank=1, kill_after=9, fetch_step=4,
          steps=28, snap_every=4, batch=32, seq=512, model="base",
          cpu=False, hb_timeout=2.0, retain_s=30.0, trace_step=None,
          min_step_s=0.0, timeout=900.0):
    """Run a gang of ``world`` rank processes of this tool against a
    ``GangKVServer`` in a process of its own, SIGKILL rank ``kill_rank``
    once it
    reports step ``kill_after`` done, and return every surviving rank's
    result with ``kill_t`` (the wall time of the kill) and ``fetch``: one
    timed pull, over TCP from the doomed rank's store, of its own
    snapshot at ``fetch_step`` (ms, bytes), made before the kill."""
    import signal
    import socket
    import subprocess
    import threading
    from pathlib import Path

    from .. import checkpoint, distributed

    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if cpu:
        env["OMP_NUM_THREADS"] = "1"    # ranks share the host's cores
    # the KV daemon in a process of its own, as a deployment runs it: its
    # handler threads must not wait on this process's fetch for the GIL.
    # It starts beside the ranks, on a port free now; a rank reaches the
    # KV only after building its model
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % probe.getsockname()[1]
    server = subprocess.Popen(
        [sys.executable, "-c", _SERVE, addr], cwd=root, env=env,
        text=True, stdin=subprocess.PIPE)
    procs, logs = {}, {}
    for r in range(world):
        args = [sys.executable, "-m", "mxnet_tpu_torch.tools.gang_bert",
                "--rank", str(r), "--world", str(world),
                "--addr", addr,
                "--out", os.path.join(workdir, f"rank{r}.json"),
                "--steps", str(steps), "--snap-every", str(snap_every),
                "--batch", str(batch), "--seq", str(seq), "--model", model,
                "--hb-timeout", str(hb_timeout),
                "--retain-s", str(retain_s),
                "--min-step-s", str(min_step_s)]
        if cpu:
            args.append("--cpu")
        if trace_step is not None and r != kill_rank:
            args += ["--trace-step", str(trace_step)]
        logs[r] = open(os.path.join(workdir, f"rank{r}.err"), "w")
        procs[r] = subprocess.Popen(
            args, cwd=root, env=env, stderr=logs[r], text=True,
            stdout=subprocess.PIPE if r == kill_rank else subprocess.DEVNULL)
    out = {"kill_t": None, "fetch": None, "doomed_lines": []}
    client = distributed.TcpKV(addr)
    puller = checkpoint.PeerSnapshotStore(world, kv=client)

    def fetch(step):
        t0 = time.perf_counter()
        got = puller.fetch(kill_rank, kill_rank, step, timeout=60.0)
        if got is None:
            raise RuntimeError(f"rank {kill_rank} held no step {step}")
        out["fetch"] = {"step": step,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "wire_ms": puller.stats.get("fetch_ms"),
                        "leaves": len(checkpoint._flatten(got)[0])}

    fetcher = None
    try:
        for line in procs[kill_rank].stdout:
            rec = json.loads(line)
            out["doomed_lines"].append(rec)
            if fetcher is None and fetch_step in rec.get("held", ()):
                fetcher = threading.Thread(target=fetch, args=(fetch_step,))
                fetcher.start()
            if rec["step"] >= kill_after and (fetcher is None
                                              or not fetcher.is_alive()):
                procs[kill_rank].send_signal(signal.SIGKILL)
                out["kill_t"] = time.time()
                break
        procs[kill_rank].wait(timeout=60)
        for r, p in procs.items():
            if r != kill_rank:
                p.wait(timeout=timeout)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        if fetcher is not None:
            fetcher.join(timeout=60)
        client.close()
        server.stdin.close()            # the daemon exits
        try:
            server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    for r, p in procs.items():
        if r == kill_rank:
            continue
        if p.returncode != 0:
            with open(os.path.join(workdir, f"rank{r}.err")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"gang rank {r} exited {p.returncode}:\n"
                               f"{tail}")
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out[r] = json.load(f)
    if out["kill_t"] is None:
        raise RuntimeError(f"rank {kill_rank} never reported step "
                           f"{kill_after}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--snap-every", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--model", choices=("base", "tiny"), default="base")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    ap.add_argument("--hb-timeout", type=float, default=2.0)
    ap.add_argument("--retain-s", type=float, default=30.0)
    ap.add_argument("--trace-step", type=int, default=None)
    ap.add_argument("--min-step-s", type=float, default=0.0)
    a = ap.parse_args(argv)
    run(a.rank, a.world, a.addr, a.out, steps=a.steps,
        snap_every=a.snap_every, batch=a.batch, seq=a.seq, model=a.model,
        device="cpu" if a.cpu else None, hb_timeout=a.hb_timeout,
        retain_s=a.retain_s, trace_step=a.trace_step,
        min_step_s=a.min_step_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
