"""The recommender workload on one card: the port's counterpart of the JAX
package's ``bench_embedding`` (``bench.py``), same configuration.

    python3 -m mxnet_tpu_torch.tools.bench_embedding [--vocab 4096]
        [--dim 64] [--batch 512] [--steps 20] [--dense]

prints one JSON line: ``metric`` ``embeddings_per_sec`` (ids a second)
with ``value`` from the captured step (``Trainer.train_step`` as one CUDA
graph replay a step, each step read back), ``captured_us`` and
``eager_us`` (the eager row-sparse oracle, ``MXTPU_SPARSE_CAPTURED=0``,
in the same process), ``speedup_vs_eager``, ``sparse_captured_le_eager``,
``lookup_us`` (the host id prep a step: unique, inverse and padding,
the read of the ids to the host included), ``lookup_stall_share``
(``lookup_us`` over the step time), ``unique_fraction``, the capture
counters, ``peak_mem_gib`` (the peak the run allocates over what was
allocated when it began, ``base_mem_gib``: the whole run, the model's
build included) and the card's name and power limit as ``nvidia-smi``
reads them.

The configuration is ``bench.py``'s (``BENCH_EMB_*``): a
``ShardedEmbedding(vocab, dim)`` and a ``Dense(1, in_units=dim,
flatten=False)`` in a hybridized ``HybridSequential``, Xavier, Adam at lr
1e-3, the loss ``(out ** 2).sum()``, ids
``RandomState(0).zipf(1.3, size=(steps + 8, batch)) % vocab`` resident on
the card, four warm-up steps.  ``--dense`` swaps the table for
``Embedding(vocab, dim)`` with a dense gradient and times its captured
step only, for comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import context, initializer, telemetry
from ..embedding import ShardedEmbedding
from ..gluon import Trainer, captured, nn
from ..ndarray.ndarray import NDArray
from .bench_bert import card_line
from .bench_trainer import _env

METRIC = "embeddings_per_sec"


def build(vocab=4096, dim=64, batch=512, steps=20, device=None,
          sparse=True):
    """The bench's net, trainer, loss and id batches (on the device)."""
    dev = context.resolve(device)
    ctx = context.context_of(dev)
    net = nn.HybridSequential(prefix="benchemb_")
    with net.name_scope():
        table = ShardedEmbedding(vocab, dim) if sparse \
            else nn.Embedding(vocab, dim)
        net.add(table, nn.Dense(1, in_units=dim, flatten=False))
    net.initialize(init=initializer.Xavier(), ctx=ctx,
                   generator=torch.Generator(device=dev).manual_seed(0))
    net.hybridize()
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    ids = np.random.RandomState(0).zipf(1.3, size=(steps + 8, batch)) \
        % vocab
    xs = [NDArray(torch.as_tensor(b.astype("float32"), device=dev), ctx)
          for b in ids]
    return net, trainer, (lambda out: (out ** 2).sum()), xs


def _loop(step, n, records=False):
    """Seconds a step over ``n`` steps, each read back; with ``records``
    also the mean ``lookup_us`` and ``unique_fraction`` of the steps'
    telemetry records."""
    t0 = time.perf_counter()
    for _ in range(n):
        float(step().asscalar())
    dt = (time.perf_counter() - t0) / n
    recs = telemetry.recent_steps()[-n:] if records else []
    if len(recs) < n or any(r.get("lookup_us") is None for r in recs):
        return dt, None, None
    return (dt, float(np.mean([r["lookup_us"] for r in recs])),
            float(np.mean([r["unique_fraction"] for r in recs])))


def run(vocab=4096, dim=64, batch=512, steps=20, device=None, sparse=True):
    """Build the bench's model and time its captured step (and, for the
    row-sparse table, the eager oracle); returns the line as a dict."""
    dev = context.resolve(device)
    cuda = dev.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    net, trainer, loss_fn, xs = build(vocab, dim, batch, steps, dev, sparse)
    cursor = [0]

    def step():
        x = xs[cursor[0] % len(xs)]
        cursor[0] += 1
        return trainer.train_step(net, loss_fn, x, batch_size=batch)

    with _env(MXTPU_SPARSE_CAPTURED="1"):
        for _ in range(4):      # records the buckets the stream hits
            float(step().asscalar())
        captured.reset_counters()
        telemetry.reset()
        captured_s, lookup_us, unique_fraction = _loop(step, steps,
                                                       records=sparse)
        stats = captured.cache_stats()
        traces, dispatches = captured.trace_count(), captured.dispatch_count()
    eager_s = None
    if sparse:
        with _env(MXTPU_SPARSE_CAPTURED="0"):
            for _ in range(2):
                float(step().asscalar())
            eager_s, _, _ = _loop(step, steps)
    captured_us = captured_s * 1e6
    eager_us = None if eager_s is None else eager_s * 1e6
    return {
        "metric": METRIC,
        "impl": "torch",
        "value": batch / captured_s,
        "unit": "ids/sec",
        "sparse": bool(sparse),
        "captured_us": captured_us,
        "eager_us": eager_us,
        "speedup_vs_eager": None if eager_us is None
        else eager_us / captured_us,
        "sparse_captured_le_eager": None if eager_us is None
        else captured_us <= eager_us,
        "lookup_us": lookup_us,
        "lookup_stall_share": None if lookup_us is None
        else lookup_us / captured_us,
        "unique_fraction": unique_fraction,
        "cache_hits": stats["hits"],
        "cache_misses": stats["misses"],
        "traces": traces,
        "dispatches": dispatches,
        "steps_timed": steps,
        "vocab": vocab, "dim": dim, "batch": batch,
        "backend": "gpu" if cuda else "cpu",
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) - base)
        / 2 ** 30 if cuda else None,
        "base_mem_gib": base / 2 ** 30 if cuda else None,
        "device_name": torch.cuda.get_device_name(dev) if cuda else None,
        "nvidia_smi": card_line() if cuda else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    env = os.environ
    ap.add_argument("--vocab", type=int,
                    default=int(env.get("BENCH_EMB_VOCAB", 4096)))
    ap.add_argument("--dim", type=int,
                    default=int(env.get("BENCH_EMB_DIM", 64)))
    ap.add_argument("--batch", type=int,
                    default=int(env.get("BENCH_EMB_BATCH", 512)))
    ap.add_argument("--steps", type=int,
                    default=int(env.get("BENCH_EMB_STEPS", 20)))
    ap.add_argument("--dense", action="store_true",
                    help="a dense-gradient Embedding instead of the table")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.vocab, args.dim, args.batch, args.steps,
                         sparse=not args.dense)), flush=True)


if __name__ == "__main__":
    main()
