"""The Gluon train step's host cost on one card: the port's counterpart of
the JAX package's ``bench_trainer`` (``bench.py``), same configuration.

    python3 -m mxnet_tpu_torch.tools.bench_trainer [--params 160]
        [--steps 30]

prints one JSON line: ``metric`` ``trainer_step_us`` with ``value`` the
captured step's microseconds (``Trainer.train_step`` as one CUDA graph
replay and one readback), ``grouped_us`` (``MXTPU_CAPTURED_STEP=0``: the
eager step with the grouped multi-tensor update), ``legacy_us``
(``MXTPU_FUSED_STEP=0`` as well: the per-parameter update loop),
``first_step_ms`` (model built to the first loss read back: deferred
init, warm-up and capture), the capture counters, the guard's overhead
(``MXTPU_GRAD_GUARD=0`` against the default), and the card's name and
power limit as ``nvidia-smi`` reads them.

The configuration is ``bench.py``'s: ``params`` parameters as
``params // 2`` ``Dense(32, in_units=32, flatten=False)`` layers in a
hybridized ``HybridSequential``, Xavier, Adam at lr 1e-3, the loss
``(out ** 2).sum()``, a (8, 32) batch from ``RandomState(0)``, and a
readback of every step's loss.  Tensors are tiny on purpose: the metric is
the step's host and launch cost, not FLOPs.  Left out until their modules
land: the telemetry breakdown and the compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import context, initializer
from ..gluon import Trainer, captured, nn
from ..ndarray.ndarray import NDArray
from .bench_bert import card_line

METRIC = "trainer_step_us"


def build(n_params=160, device=None):
    """The bench's net, trainer and batch: returns (net, trainer, loss_fn,
    x)."""
    dev = context.resolve(device)
    ctx = context.context_of(dev)
    net = nn.HybridSequential(prefix="bench_")
    with net.name_scope():
        for _ in range(max(1, n_params // 2)):    # Dense = weight + bias
            net.add(nn.Dense(32, in_units=32, flatten=False))
    net.initialize(init=initializer.Xavier(), ctx=ctx,
                   generator=torch.Generator(device=dev).manual_seed(0))
    net.hybridize()
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    x = NDArray(torch.as_tensor(np.random.RandomState(0).standard_normal(
        (8, 32)).astype("float32"), device=dev), ctx)
    return net, trainer, (lambda out: (out ** 2).sum()), x


def _timed(step, steps):
    """Seconds a step over ``steps`` steps, each ending in a readback."""
    t0 = time.perf_counter()
    for _ in range(steps):
        float(step().asscalar())
    return (time.perf_counter() - t0) / steps


class _env:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(n_params=160, steps=30, device=None):
    """Build the bench's path and time the captured, grouped and legacy
    steps; returns the result line as a dict."""
    dev = context.resolve(device)
    t0 = time.perf_counter()
    net, trainer, loss_fn, x = build(n_params, dev)

    def step():
        return trainer.train_step(net, loss_fn, x, batch_size=8)

    with _env(MXTPU_CAPTURED_STEP="1"):
        float(step().asscalar())
        first_step_ms = (time.perf_counter() - t0) * 1e3
        float(step().asscalar())
        captured.reset_counters()
        captured_us = _timed(step, steps) * 1e6
        stats = captured.cache_stats()
        traces, dispatches = captured.trace_count(), captured.dispatch_count()
        with _env(MXTPU_GRAD_GUARD="0"):
            for _ in range(2):
                float(step().asscalar())
            noguard_us = _timed(step, steps) * 1e6
    with _env(MXTPU_CAPTURED_STEP="0"):
        for _ in range(2):
            float(step().asscalar())
        grouped_us = _timed(step, steps) * 1e6
        with _env(MXTPU_FUSED_STEP="0"):
            float(step().asscalar())
            legacy_us = _timed(step, max(3, steps // 5)) * 1e6
    cuda = dev.type == "cuda"
    return {
        "metric": METRIC,
        "impl": "torch",
        "value": captured_us,
        "unit": "us/step",
        "grouped_us": grouped_us,
        "legacy_us": legacy_us,
        "speedup": legacy_us / captured_us,
        "speedup_vs_grouped": grouped_us / captured_us,
        "captured_le_grouped": captured_us <= grouped_us,
        "first_step_ms": first_step_ms,
        "cache_hits": stats["hits"],
        "cache_misses": stats["misses"],
        "traces": traces,
        "dispatches": dispatches,
        "guard_overhead_us": captured_us - noguard_us,
        "params": sum(1 for p in net.collect_params().values()
                      if p.grad_req != "null"),
        "batch": 8,
        "steps": steps,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if cuda else None,
        "nvidia_smi": card_line() if cuda else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", type=int, default=160)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.params, args.steps)), flush=True)


if __name__ == "__main__":
    main()
