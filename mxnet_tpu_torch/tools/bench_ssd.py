"""SSD training at the width of SSD-300 on PASCAL VOC, on one card.

    python3 -m mxnet_tpu_torch.tools.bench_ssd [--batch 32] [--image 300]
        [--steps 20] [--warmup 2] [--seed 0]

trains ``gluon.model_zoo.SSD`` with ``SSDTrainLoss`` (``MultiBoxTarget``
with hard-negative mining at 3:1, cross-entropy and smooth-L1) through
``gluon.Trainer`` (SGD, lr 0.004, momentum 0.9, wd 5e-4), Xavier from a
seed, in f32.  The configuration (``VOC300``) follows MXNet's
example/ssd (``symbol/symbol_factory.py``, ``get_config("vgg16_reduced",
300)``, and ``train.py``'s defaults) and Liu et al., arXiv:1512.02325
section 3: 20 classes, 3x300x300 inputs, six scales with the example's
sizes, ratios (1, 2, .5) on the first and the last two scales and (1, 2,
.5, 3, 1/3) on the middle three, VGG-16's stage widths then SSD's 256.
The model zoo's SSD has one conv-BN-ReLU-maxpool stage a scale, each
halving the map, so the six maps are 150, 75, 37, 18, 9 and 4 (134296
anchors) where VGG16-reduced's are 38 ... 1: the one way the run differs
from SSD-300.  The data is synthetic and seeded (``synthetic_batch``,
``examples/train_ssd.py``'s generator widened to 300x300 and 20 classes):
1-6 boxes an image, each class its own aspect ratio and intensity,
labels padded with cls -1 to 16 rows.

Prints one JSON line: ``ms_per_step`` (the median of the timed steps,
each closed by a readback of its loss) with ``ms_min``/``ms_max``,
``images_per_sec`` at the median, the losses of every step (warm-up
included) and the first and last of them,
``peak_mem_gib`` (the run's peak allocation over what was allocated when
it began), and from one torch.profiler trace of three more steps held
whole by ``trace_edges``' fences: ``busy_share`` (the time some kernel
runs on the device over host wall time; kernels that overlap count
once), ``kernel_ms_per_step`` (the kernels' summed time) and
``kernels_per_step``; then the card's name and power
limit as ``nvidia-smi`` reads them.  On the host the card's numbers are
``None``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import autograd, context, initializer
from ..gluon import Trainer
from ..gluon.model_zoo.ssd import SSD, SSDTrainLoss
from ..ndarray.ndarray import NDArray

#: SSD-300 on VOC (example/ssd's vgg16_reduced at 300; Liu et al. 2016)
VOC300 = dict(
    num_classes=20, image=300, batch=32,
    base_channels=(64, 128, 256, 512, 512, 256),
    scale_sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                 (.71, .79), (.88, .961)),
    scale_ratios=((1, 2, .5),) + ((1, 2, .5, 3, 1 / 3),) * 3
    + ((1, 2, .5),) * 2,
    lr=0.004, momentum=0.9, wd=5e-4, negative_mining_ratio=3,
    max_objects=16)
PROFILE_STEPS = 3
#: distinct synthetic batches the timed steps cycle through
DATA_BATCHES = 8


def synthetic_batch(rng, batch, size, num_classes, max_objects=16,
                    max_boxes=6):
    """(images (B, 3, size, size) f32, labels (B, max_objects, 5) f32):
    1 to ``max_boxes`` filled rectangles an image on a dark noisy field;
    class c has its own width-to-height ratio (from 1/3 to 3) and its own
    intensity; label rows [cls, xmin, ymin, xmax, ymax] in [0, 1], padded
    with -1."""
    aspect = np.exp(np.linspace(np.log(1 / 3), np.log(3), num_classes))
    level = np.linspace(0.3, 1.0, num_classes)
    x = rng.uniform(0, 0.1, (batch, 3, size, size)).astype(np.float32)
    lab = -np.ones((batch, max_objects, 5), np.float32)
    for b in range(batch):
        for m in range(rng.randint(1, max_boxes + 1)):
            cls = rng.randint(num_classes)
            area = rng.uniform(0.02, 0.2)
            w = min(np.sqrt(area * aspect[cls]), 0.95)
            h = min(np.sqrt(area / aspect[cls]), 0.95)
            x0 = rng.uniform(0, 1 - w)
            y0 = rng.uniform(0, 1 - h)
            box = [x0, y0, x0 + w, y0 + h]
            px = [int(round(v * size)) for v in box]
            x[b, :, px[1]:px[3], px[0]:px[2]] = level[cls]
            lab[b, m] = [cls] + box
    return x, lab


def build(cfg, device=None, seed=0):
    """The SSD of ``cfg`` (Xavier from ``seed``; its deferred shapes come
    at the first forward), its SGD trainer and the loss."""
    dev = context.resolve(device)
    net = SSD(num_classes=cfg["num_classes"],
              base_channels=cfg["base_channels"],
              scale_sizes=cfg["scale_sizes"],
              scale_ratios=cfg["scale_ratios"])
    net.initialize(init=initializer.Xavier(), ctx=context.context_of(dev),
                   generator=torch.Generator(device=dev).manual_seed(seed))
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": cfg["lr"],
                       "momentum": cfg["momentum"], "wd": cfg["wd"]})
    return net, trainer, SSDTrainLoss(cfg["negative_mining_ratio"])


def batches(cfg, n, device=None, seed=0):
    """``n`` seeded (data, label) NDArray pairs on the device."""
    dev = context.resolve(device)
    ctx = context.context_of(dev)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x, y = synthetic_batch(rng, cfg["batch"], cfg["image"],
                               cfg["num_classes"], cfg["max_objects"])
        out.append((NDArray(torch.as_tensor(x, device=dev), ctx),
                    NDArray(torch.as_tensor(y, device=dev), ctx)))
    return out


def train_step(net, trainer, loss_fn, x, y):
    """One step: forward and loss under ``autograd.record()``, backward,
    ``trainer.step(B)``.  Returns the loss."""
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def run(steps=20, warmup=2, batch=VOC300["batch"], image=VOC300["image"],
        device=None, seed=0, cfg=None):
    """Train ``warmup + steps`` steps (and ``PROFILE_STEPS`` more under
    the profiler on a card); returns the result line as a dict.  ``cfg``
    (default ``VOC300``) with ``batch`` and ``image`` put in."""
    cfg = dict(cfg or VOC300, batch=batch, image=image)
    dev = context.resolve(device)
    cuda = dev.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    net, trainer, loss_fn = build(cfg, dev, seed)
    data = batches(cfg, min(DATA_BATCHES, warmup + steps), dev, seed)
    losses, times = [], []

    def step(i):
        return float(train_step(net, trainer, loss_fn,
                                *data[i % len(data)]).asscalar())

    for i in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(i))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    ms = sorted(t * 1e3 for t in times)
    med = ms[len(ms) // 2]
    out = {
        "metric": "ssd300_ms_per_step",
        "impl": "torch",
        "value": med,
        "unit": "ms",
        "ms_per_step": med, "ms_min": ms[0], "ms_max": ms[-1],
        "images_per_sec": cfg["batch"] / (med / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "steps_timed": steps, "warmup": warmup,
        "batch": cfg["batch"], "image": cfg["image"],
        "num_classes": cfg["num_classes"],
        "anchors": int(net(data[0][0][:1])[2].shape[1]),
        "dtype": "float32",
        "params": sum(p.data().size for p in net.collect_params().values()),
        "backend": "gpu" if cuda else "cpu",
        "busy_share": None, "kernel_ms_per_step": None,
        "kernels_per_step": None,
        "peak_mem_gib": None, "device_name": None, "nvidia_smi": None,
    }
    if cuda:
        from .bench_bert import card_line
        from .bench_lstm import _profile

        out.update(_profile(step, warmup + steps, PROFILE_STEPS))
        out.update(peak_mem_gib=(torch.cuda.max_memory_allocated(dev)
                                 - base) / 2 ** 30,
                   device_name=torch.cuda.get_device_name(dev),
                   nvidia_smi=card_line())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=VOC300["batch"])
    ap.add_argument("--image", type=int, default=VOC300["image"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = vars(ap.parse_args(argv))
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd: measures the card; no CUDA device")
    print(json.dumps(run(**a)), flush=True)


if __name__ == "__main__":
    main()
