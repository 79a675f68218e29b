"""BERT-base over a gang of ranks: the dist store, the collectives and the
sharded trainer, one process a rank.

    python3 -m mxnet_tpu_torch.tools.dist_bert --rank R --world N
        --out DIR [--batch 32] [--seq 512] [--steps 3] [--timed 5]
        [--model base|tiny]

with the launch variables ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_WORKERS`` /
``MXTPU_WORKER_RANK`` set (``drive`` sets them).  Each rank joins the
process group (the backend
by ``distributed.backend_rule``, which the rank prints: gloo when the
ranks share one card) and runs, in order:

- ``probe``: which collectives the backend accepts on the rank's tensors
  (``parallel.collectives.probe``);
- ``kv``: a ``dist_sync`` store's pushes summed, and 2-bit compression's
  codes, residuals and decoded sum on the rank's device equal to the same
  arithmetic on the host;
- ``check``: BERT (``bench_bert``'s width with ``--model base``: 12
  layers, 768 wide, 12 heads; ``bert_tiny`` with ``--model tiny``) in f32
  with dropout 0 on the flash trunk, ``--steps`` AdamW steps on the same
  global batches through ``ShardedTrainer`` at dp=N, tp=N and fsdp=N and
  through ``gluon.Trainer(kvstore="dist_sync")`` (each rank its block of
  the batch): the losses, a fixed sample of the trained parameters and
  the flash wrappers' launches of each path;
- ``timing``: the same four paths in bf16, 2 warm-up and ``--timed``
  timed steps: ms a step (median, min, max) and the bytes the step moved
  in collectives; then ``--timed`` more steps under
  ``collectives.timed_collectives`` for the seconds the collectives take
  with the card idle before each.

The rank writes its result to ``DIR/rank<R>.json``.  ``drive`` starts
the gang and returns the results; ``reference`` runs the one-rank
``ShardedTrainer`` on the same global batches and samples, for the
caller to hold the paths against.  Every batch has the same number of
masked tokens in each sequence, so a rank's mean over its block and the
global mean agree (the ``dist_sync`` path averages the ranks' means).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

SEED = 0
ADAMW = {"learning_rate": 1e-4, "wd": 0.01}
PATHS = ("dp", "tp", "fsdp", "dist_sync")
#: the parameters sampled after training, and the sample's size
SAMPLED = ("word_embed_weight", "enc_qkv_stack_weight",
           "enc_ffn1_stack_weight", "enc_ffn2_stack_weight",
           "pooler_weight", "dec_transform_weight")
SAMPLE = 512


def build(model, seq, device, dtype="float32"):
    """The net, drawn from ``SEED`` on ``device`` (dropout 0, flash trunk,
    scanned layers), cast to ``dtype``."""
    from ..gluon.model_zoo import bert
    from ..initializer import Xavier

    make = bert.bert_base if model == "base" else bert.bert_tiny
    net = make(dropout=0.0, max_length=seq, scan_layers=True,
               attention_impl="flash", device=device)
    dev = net.word_embed_weight.data()._data.device
    net.initialize(init=Xavier(),
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    if dtype != "float32":
        net.cast(dtype)
    return net


def batches(steps, batch, seq, vocab, device):
    """``steps`` global batches (tokens, (mlm, nsp)): every sequence has
    round(0.15 T) masked tokens."""
    rng = np.random.RandomState(SEED + 1)
    top = min(30000, vocab)
    k = max(1, round(0.15 * seq))
    out = []
    for _ in range(steps):
        tokens = rng.randint(0, top, (batch, seq))
        mlm = np.full((batch, seq), -1, np.int64)
        for b in range(batch):
            pos = rng.choice(seq, k, replace=False)
            mlm[b, pos] = rng.randint(0, top, k)
        nsp = rng.randint(0, 2, (batch,))
        t = [torch.as_tensor(a, dtype=torch.int64, device=device)
             for a in (tokens, mlm, nsp)]
        out.append((t[0], (t[1], t[2])))
    return out


def sample_index(numel):
    return np.random.RandomState(SEED + 2).randint(0, numel, SAMPLE)


def _sample(name, full):
    flat = full.detach().float().reshape(-1).cpu().numpy()
    return flat[sample_index(flat.size)].tolist()


def _short(net, name):
    return name[len(net.prefix):]


def _samples_sharded(tr):
    """The sampled parameters' full values (a collective over the mesh for
    a sharded one)."""
    out = {}
    for i, (name, t) in enumerate(tr._trainable):
        short = _short(tr.block, name)
        if short in SAMPLED:
            loc = tr._local[i]
            out[short] = _sample(short, t if loc is None
                                 else tr._full(i, loc))
    return out


def _samples_gluon(net):
    return {_short(net, n): _sample(_short(net, n), p.data()._data)
            for n, p in net.collect_params().items()
            if _short(net, n) in SAMPLED}


def _flash():
    from ..ops import flash_attention as fa

    return (fa.flash_attention_fwd, fa.flash_attention_dq,
            fa.flash_attention_dkv)


def _zero_flash():
    for fn in _flash():
        fn.launches = 0


def _flash_counts():
    return {fn.__name__: fn.launches for fn in _flash()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference(model, batch, seq, steps, device):
    """The one-rank ``ShardedTrainer`` on the global batches: losses and
    the samples."""
    from ..gluon.model_zoo import bert
    from ..parallel import ShardedTrainer

    net = build(model, seq, device)
    tr = ShardedTrainer(net, bert.BERTPretrainLoss(), "adamw", dict(ADAMW))
    data = batches(steps, batch, seq, net._vocab, device)
    losses = [float(tr.step(x, y)) for x, y in data]
    out = {"losses": losses, "samples": _samples_sharded(tr)}
    del tr, net
    return out


def _path_trainer(path, net, world, device):
    """(step(x, y) -> loss, samples()) for one of ``PATHS``."""
    from .. import autograd, gluon, parallel
    from ..gluon.model_zoo import bert
    from ..ndarray.ndarray import NDArray

    loss_fn = bert.BERTPretrainLoss()
    if path == "dist_sync":
        tr = gluon.Trainer(net.collect_params(), "adamw", dict(ADAMW),
                           kvstore="dist_sync")
        mesh = parallel.make_mesh(dp=world)
        r = mesh.coord("dp")
        from .. import context

        ctx = context.context_of(device)

        def step(x, y):
            b = x.shape[0] // world
            rows = slice(r * b, (r + 1) * b)
            with autograd.record():
                out = net(NDArray(x[rows], ctx))
                loss = loss_fn(out, tuple(NDArray(a[rows], ctx) for a in y))
            loss.backward()
            tr.step(world)
            # the global loss: the ranks' local means averaged
            g = loss._data.detach().float().reshape(1).clone()
            parallel.collectives.all_reduce_(g, mesh.all_group, "loss")
            return g[0] / world

        return step, lambda: _samples_gluon(net)
    axes = {"dp": {"dp": world}, "tp": {"tp": world},
            "fsdp": {"dp": world}}[path]
    mesh = parallel.make_mesh(**axes)
    kw = {"rules": parallel.TRANSFORMER_TP_RULES} if path == "tp" \
        else ({"mode": "fsdp"} if path == "fsdp" else {})
    tr = parallel.ShardedTrainer(net, loss_fn, "adamw", dict(ADAMW),
                                 mesh=mesh, **kw)
    return tr.step, lambda: _samples_sharded(tr)


def _check(args, device, world):
    out = {}
    for path in PATHS:
        net = build(args.model, args.seq, device)
        step, samples = _path_trainer(path, net, world, device)
        data = batches(args.steps, args.batch, args.seq, net._vocab, device)
        _zero_flash()
        losses = [float(step(x, y)) for x, y in data]
        _sync(device)
        launches = _flash_counts()
        out[path] = {"losses": losses, "launches": launches,
                     "samples": samples()}
        del step, samples, net
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _timing(args, device, world):
    from ..parallel import collectives

    out = {}
    for path in PATHS:
        net = build(args.model, args.seq, device, dtype="bfloat16")
        step, _ = _path_trainer(path, net, world, device)
        data = batches(1, args.batch, args.seq, net._vocab, device)[0]
        for _ in range(2):
            step(*data)
        _sync(device)
        ms, coll_s, coll_b = [], [], []
        for _ in range(args.timed):
            collectives.stats(reset=True)
            t0 = time.perf_counter()
            float(step(*data))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            coll_b.append(collectives.stats()["bytes"])
        # the collectives' own time, in steps of their own: each
        # collective waits for the card before and after it, which the
        # steps timed above do not
        with collectives.timed_collectives():
            for _ in range(args.timed):
                collectives.stats(reset=True)
                float(step(*data))
                coll_s.append(collectives.stats()["seconds"])
        out[path] = {"ms_median": statistics.median(ms), "ms_min": min(ms),
                     "ms_max": max(ms), "ms": ms,
                     "collective_s_median": statistics.median(coll_s),
                     "collective_bytes": coll_b[-1],
                     "peak_mem_gib": (torch.cuda.max_memory_allocated(device)
                                      / 2 ** 30 if device.type == "cuda"
                                      else None)}
        del step, net
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return out


def _kv(device, world, rank):
    """The store's sum and 2-bit compression on the rank's device against
    the same arithmetic on the host."""
    from .. import context, kvstore, nd
    from ..gradient_compression import GradientCompression

    ctx = context.context_of(device)
    kv = kvstore.create("dist_sync")
    kv.init("w", nd.zeros((1024,), ctx=ctx))
    kv.push("w", nd.ones((1024,), ctx=ctx) * (rank + 1))
    got = nd.zeros((1024,), ctx=ctx)
    kv.pull("w", out=got)
    sum_ok = bool((got.asnumpy() == world * (world + 1) / 2).all())
    kv2 = kvstore.create("dist_sync")
    kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv2.init("g", nd.zeros((4099,), ctx=ctx))
    hosts = [GradientCompression({"type": "2bit", "threshold": 0.5})
             for _ in range(world)]
    residual_equal = pulled_equal = True
    for rnd in range(3):
        gs = [np.random.RandomState(500 + 10 * r + rnd).randn(4099)
              .astype(np.float32) * 0.6 for r in range(world)]
        kv2.push("g", nd.array(gs[rank], ctx=ctx))
        out = nd.zeros((4099,), ctx=ctx)
        kv2.pull("g", out=out)
        packed = [hosts[r].codes("g", torch.from_numpy(gs[r]))
                  for r in range(world)]
        want = GradientCompression.decode_sum(torch.stack(packed), 4099, 0.5,
                                              "float32")
        pulled_equal &= bool(np.array_equal(out.asnumpy(), want.numpy()))
        residual_equal &= bool(np.array_equal(
            kv2._compression._residual["g"].cpu().numpy(),
            hosts[rank]._residual["g"].numpy()))
    # the codes themselves, card against host, on one gradient
    g = np.random.RandomState(600 + rank).randn(4099).astype(np.float32)
    on_card = GradientCompression({"type": "2bit", "threshold": 0.5}).codes(
        "c", torch.as_tensor(g, device=device))
    on_host = GradientCompression({"type": "2bit", "threshold": 0.5}).codes(
        "c", torch.from_numpy(g))
    codes_equal = bool(np.array_equal(on_card.cpu().numpy(),
                                      on_host.numpy()))
    return {"sum_ok": sum_ok, "codes_equal": codes_equal,
            "residual_equal": residual_equal,
            "pulled_equal": pulled_equal, "device": str(device)}


def rank_main(args):
    from .. import distributed
    from ..parallel import collectives
    from ..parallel.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert distributed.init_from_env()
    rank, world = distributed.rank(), distributed.num_workers()
    import torch.distributed as dist

    device = rank_device()
    res = {"rank": rank, "world": world,
           "backend": dist.get_backend(), "device": str(device)}
    t0 = time.perf_counter()
    res["probe"] = collectives.probe(device)
    res["kv"] = _kv(device, world, rank)
    res["check"] = _check(args, device, world)
    res["check_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    res["timing"] = _timing(args, device, world)
    res["timing_s"] = time.perf_counter() - t1
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.barrier("dist_bert_end")


def drive(workdir, world=2, batch=32, seq=512, steps=3, timed=5,
          model="base", timeout=600.0):
    """Run a gang of ``world`` rank processes of this tool and return
    ``[result of rank r]``.  Raises, with the ranks' output, when one
    fails or the gang outlives ``timeout``."""
    import socket
    import subprocess
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[2])
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % probe.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, MXTPU_COORDINATOR=addr,
                   MXTPU_NUM_WORKERS=str(world), MXTPU_WORKER_RANK=str(r),
                   PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        args = [sys.executable, "-m", "mxnet_tpu_torch.tools.dist_bert",
                "--rank", str(r), "--world", str(world), "--out", workdir,
                "--batch", str(batch), "--seq", str(seq), "--steps",
                str(steps), "--timed", str(timed), "--model", model]
        logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(args, cwd=root, env=env,
                                      stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"-- rank {r} --\n" + f.read())
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("dist_bert: a rank failed\n" + "\n".join(text))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
        out[-1]["log"] = text[r]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--timed", type=int, default=5)
    ap.add_argument("--model", choices=("base", "tiny"), default="base")
    rank_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
