"""ResNet-50 v1 training throughput on one card: the port's counterpart of
the JAX package's ``bench_resnet`` (``bench.py``), same configuration and
timing.

    python3 -m mxnet_tpu_torch.tools.bench_resnet [--batch 256] [--image 224]
        [--steps 10] [--layout NCHW|NHWC] [--path sharded|gluon|captured]

prints one JSON line: ``metric`` ``resnet50_train_samples_per_sec_per_chip``,
``impl`` ``torch``, ``value`` (samples/s), the final ``loss`` and the whole
trajectory, ``ms_per_step``, ``mfu``, ``peak_mem_gib``, the layout and
batch, ``path``, ``cudnn_benchmark`` (true), the card's name and power
limit as ``nvidia-smi`` reads them, and ``data_stall_share`` and
``data_stall_share_sync``.

The path: ``resnet50_v1(classes=1000, layout=layout)``,
``initialize(init=Xavier())`` (drawn from seed 0), ``cast("bfloat16")``, and
``ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", {"learning_rate":
0.1, "momentum": 0.9, "wd": 1e-4}, mesh=data_parallel_mesh(1))`` stepped
on ``bench_resnet``'s batch: x from ``RandomState(0).standard_normal``
(N, 3, H, W) or, for NHWC, (N, H, W, 3), cast to bf16, and labels
``randint(0, 1000, N)`` as float32, one batch repeated.  ``--path gluon``
trains the same net through ``gluon.Trainer`` instead (the same SGD
hyper-parameters with ``multi_precision``, f32 master weights for the
bf16 ones; ``kvstore="device"``), as MXNet's loop does:
``autograd.record()``, ``loss.backward()``, ``trainer.step(N)``;
``--path captured`` through ``Trainer.train_step``, one CUDA graph a step.
Both hybridize the net.  The timing is
``bench_bert.measure``'s: two warm-up steps each ended by a readback, then
``steps`` steps closed by ``torch.cuda.synchronize()`` and one readback.
``torch.backends.cudnn.benchmark`` is this tool's setting: on for the
run (cuDNN picks each convolution's algorithm by timing it in the
warm-up steps) and restored after; the library never sets it.

``data_stall_share`` and ``data_stall_share_sync`` are ``bench_resnet``'s
(``bench.py:2146-2199``): the same step driven by a host pipeline —
``image.normalize_flip_batch_np`` on a uint8 (N, H, W, 3) batch, the
bf16 cast on the host with torch (so bf16 bytes cross PCIe), and
``DevicePrefetcher`` at depth 2 (pinned staging, its own copy stream)
and at depth 0 (synchronous) — over ``max(4, steps // 2)`` steps each,
every step ended by a readback: the share of wall time the loop waited
in ``next()`` for its batch.  ``run(stall=False)`` leaves them out.

MFU counts ``bench_resnet``'s FLOPs, 3 * 2 * 4.089e9 per 224x224 image
scaled by (image / 224)^2, against the H100's dense bf16 tensor-core peak
(``bench_bert.mfu``); it is null on another card and on the host, and
above ``bench_bert.MFU_GATE`` the run raises (the clock stopped before
the card finished).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import context
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo import vision
from ..initializer import Xavier
from ..parallel import ShardedTrainer, data_parallel_mesh
from .bench_bert import measure

METRIC = "resnet50_train_samples_per_sec_per_chip"
DTYPE = "bfloat16"                  # bench_resnet's only configuration
#: bench_resnet's forward FLOPs of one 224x224 image, times 3 for the step
RESNET50_TRAIN_FLOPS_224 = 3 * 2 * 4.089e9


def flops_per_step(batch, image):
    """``bench_resnet``'s FLOP count of one ResNet-50 training step."""
    return RESNET50_TRAIN_FLOPS_224 * (image / 224.0) ** 2 * batch


def make_data(batch, image, layout, device, seed=0):
    """``bench_resnet``'s batch on ``device``: x (N, 3, H, W), or
    (N, H, W, 3) for NHWC, in bf16, and float32 labels in [0, 1000)."""
    rng = np.random.RandomState(seed)
    shape = (batch, 3, image, image) if layout == "NCHW" else \
        (batch, image, image, 3)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                        device=device).to(getattr(torch, DTYPE))
    y = torch.as_tensor(rng.randint(0, 1000, batch).astype(np.float32),
                        device=device)
    return x, y


def build(batch=256, image=224, layout="NCHW", device=None, seed=0):
    """The bench's trainer and batch: returns (trainer, x, y)."""
    dev = context.resolve(device)
    ctx = context.context_of(dev)
    net = vision.resnet50_v1(classes=1000, layout=layout)
    net.initialize(init=Xavier(), ctx=ctx,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    net.cast(DTYPE)
    with ctx:
        mesh = data_parallel_mesh(1)
    trainer = ShardedTrainer(
        net, SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, mesh=mesh)
    x, y = make_data(batch, image, layout, dev, seed)
    return trainer, x, y


PATHS = ("sharded", "gluon", "captured")
#: gluon.Trainer's optimizer: bench_resnet's SGD, with f32 master weights
GLUON_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
             "multi_precision": True}


def build_gluon(batch=256, image=224, layout="NCHW", device=None, seed=0):
    """The bench's net on ``gluon.Trainer``: returns (net, trainer,
    loss_fn, x, y) with x and y NDArrays; the net is hybridized."""
    from .. import gluon
    from ..ndarray.ndarray import NDArray

    dev = context.resolve(device)
    ctx = context.context_of(dev)
    net = vision.resnet50_v1(classes=1000, layout=layout)
    net.initialize(init=Xavier(), ctx=ctx,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    net.cast(DTYPE)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD),
                            kvstore="device")
    x, y = make_data(batch, image, layout, dev, seed)
    return (net, trainer, SoftmaxCrossEntropyLoss(), NDArray(x, ctx),
            NDArray(y, ctx))


def stepper(path, batch=256, image=224, layout="NCHW", device=None):
    """``path``'s training step on a given batch and the bench's batch:
    returns (step(x, y) -> mean loss, x, y), x and y NDArrays or tensors
    (the sharded path takes tensors, the Gluon paths NDArrays)."""
    if path == "sharded":
        trainer, x, y = build(batch, image, layout, device)
        return (lambda xb, yb: trainer.step(_tensor(xb), _tensor(yb)),
                x, y)
    from .. import autograd

    net, trainer, loss_fn, x, y = build_gluon(batch, image, layout, device)
    if path == "captured":
        return (lambda xb, yb: trainer.train_step(net, loss_fn, xb,
                                                  yb).mean(), x, y)

    def eager(xb, yb):
        with autograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        trainer.step(batch)
        return loss.mean()

    return eager, x, y


def _tensor(x):
    return getattr(x, "_data", x)


def step_fn(path, batch=256, image=224, layout="NCHW", device=None):
    """One training step of ``path`` on the bench's batch, as a closure
    returning the mean loss (a 0-dim tensor or NDArray)."""
    step, x, y = stepper(path, batch, image, layout, device)
    return lambda: step(x, y)


def host_batches(batch, image, layout, y, nb, seed=0):
    """``bench_resnet``'s host pipeline, ``nb`` batches: one uint8
    (N, H, W, 3) batch through ``image.normalize_flip_batch_np`` (scale
    1/255), laid out as ``layout``, cast to bf16 on the host; each yielded
    with the labels ``y`` as they are."""
    from .. import image as image_mod

    u8 = np.random.RandomState(seed).randint(
        0, 256, (batch, image, image, 3), dtype=np.uint8)
    mean = np.zeros((3, 1, 1), np.float32)
    std = np.ones((3, 1, 1), np.float32)
    for _ in range(nb):
        xb = image_mod.normalize_flip_batch_np(u8, None, 1.0 / 255, mean,
                                               std)
        if layout != "NCHW":
            xb = np.ascontiguousarray(xb.transpose(0, 2, 3, 1))
        yield torch.from_numpy(xb).to(getattr(torch, DTYPE)), y


def stall_shares(step, y, batch, image, layout, device, steps, seed=0):
    """``bench_resnet``'s data-stall shares (prefetch at depth 2, then
    synchronous): ``step(x, y)`` fed ``host_batches`` through
    ``DevicePrefetcher``; ``y`` (the labels, on the device) passes
    through."""
    from ..gluon.data import DevicePrefetcher

    ctx = context.context_of(context.resolve(device))
    nst = max(4, steps // 2)

    def share(depth):
        with ctx:
            it = iter(DevicePrefetcher(
                host_batches(batch, image, layout, y, nst, seed),
                depth=depth))
        stall = 0.0
        t0 = time.perf_counter()
        for _ in range(nst):
            ts = time.perf_counter()
            xb, yb = next(it)
            stall += time.perf_counter() - ts
            float(step(xb, yb))
        return stall / (time.perf_counter() - t0)

    return share(2), share(0)


def run(batch=256, image=224, steps=10, layout="NCHW", device=None,
        path="sharded", stall=True):
    """Build the bench's path, time ``steps`` training steps after two
    warm-up steps, and return the result line as a dict; with ``stall``,
    then measure the data-stall shares on the same step."""
    if path not in PATHS:
        raise ValueError(f"bench_resnet: path must be one of {PATHS}")
    dev = context.resolve(device)
    built = {}

    def build_step():
        step, x, y = stepper(path, batch, image, layout, dev)
        built.update(step=step, y=y)
        return lambda: step(x, y)

    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        res = measure(
            build_step, steps, dev, batch, flops_per_step(batch, image),
            metric=METRIC, unit="samples/sec/chip", batch=batch, image=image,
            layout=layout, dtype=DTYPE, path=path, cudnn_benchmark=True)
        if stall:
            res["data_stall_share"], res["data_stall_share_sync"] = \
                stall_shares(built["step"], built["y"], batch, image, layout,
                             dev, steps)
        return res
    finally:
        torch.backends.cudnn.benchmark = prev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--layout", default="NCHW", choices=("NCHW", "NHWC"))
    ap.add_argument("--path", default="sharded", choices=PATHS)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.batch, args.image, args.steps, args.layout,
                         path=args.path)),
          flush=True)


if __name__ == "__main__":
    main()
