"""Input-pipeline throughput: the port's counterpart of the JAX package's
``bench_input_pipeline`` (``bench.py:2230-2308``), same configuration and
fields.

    python3 -m mxnet_tpu_torch.tools.bench_input_pipeline [--n 1024]
        [--batch 64] [--image 32] [--workers 2]

prints one JSON line: ``metric`` ``input_pipeline_imgs_per_sec``, ``value``
(images/s of the loader wrapped in ``DevicePrefetcher``), ``legacy_ips``
and ``speedup`` (the same loader driven by the per-sample batchify: one
tensor copied to the device per SAMPLE, then a stack on the device),
``stall_share_prefetch`` and ``stall_share_sync`` (the share of wall time
a loop with a small step in it waited for its batch, prefetch at depth 2
and at depth 0), the configuration, ``backend``, ``codec`` and the
card's name and power limit as ``nvidia-smi`` reads them.

The data: ``n`` in-memory JPEGs of 32 distinct random images of
(image + 8)^2 pixels (quality 85), each decoded and center-cropped to
image^2 in the loader's thread workers (``image.imdecode_np``,
``image.center_crop_np``), with a float32 label.  Encoding and decoding
need a codec (PIL); without one ``run`` raises ``ImportError`` and the
CLI says so.  Each measurement drives one warm epoch, then a timed one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import context
from .bench_bert import card_line

METRIC = "input_pipeline_imgs_per_sec"


def _epoch_stats(loader, step_fn=None):
    """One epoch: (images/s, data-stall share).  Stall = time blocked in
    ``next()`` waiting for a batch."""
    it = iter(loader)
    imgs, stall, last = 0, 0.0, None
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        stall += time.perf_counter() - ts
        last = batch
        imgs += int(batch[0].shape[0])
        if step_fn is not None:
            step_fn(batch)
    if last is not None:
        last[0].asnumpy()
    total = time.perf_counter() - t0
    return imgs / total, stall / total


def run(n=1024, batch=64, image=32, workers=2, device=None):
    """Build the bench's loaders and return the result line as a dict."""
    from .. import image as image_mod
    from ..gluon.data import DataLoader, DevicePrefetcher
    from ..gluon.data.dataset import Dataset
    from ..ndarray.ndarray import NDArray

    import PIL

    dev = context.resolve(device)
    ctx = context.context_of(dev)
    rng = np.random.RandomState(0)
    n_unique = 32
    payloads = [
        image_mod.imencode(
            rng.randint(0, 256, (image + 8, image + 8, 3)).astype(np.uint8),
            quality=85, img_fmt=".jpg")
        for _ in range(n_unique)]

    class _JpegDataset(Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            arr = image_mod.imdecode_np(payloads[i % n_unique])
            arr = image_mod.center_crop_np(arr, (image, image))
            return arr, np.float32(i % 10)

    ds = _JpegDataset()

    def legacy_batchify(samples):
        return [NDArray(torch.stack([torch.tensor(np.asarray(s),
                                                  device=dev)
                                     for s in col]), ctx)
                for col in zip(*samples)]

    with ctx:
        legacy = DataLoader(ds, batch, num_workers=workers,
                            batchify_fn=legacy_batchify)
        new = DataLoader(ds, batch, num_workers=workers)
        prefetched = DevicePrefetcher(new, depth=2)
        sync = DevicePrefetcher(new, depth=0)

        def step_fn(b):
            float((b[0]._data.float() ** 2).sum())

        _epoch_stats(legacy)        # warm: allocator, codec, threads
        legacy_ips, _ = _epoch_stats(legacy)
        _epoch_stats(prefetched)
        new_ips, _ = _epoch_stats(prefetched)
        _, stall_pf = _epoch_stats(prefetched, step_fn)
        _, stall_sync = _epoch_stats(sync, step_fn)
    cuda = dev.type == "cuda"
    return {
        "metric": METRIC,
        "value": new_ips,
        "unit": "imgs/sec",
        "vs_baseline": None,
        "legacy_ips": legacy_ips,
        "speedup": new_ips / legacy_ips if legacy_ips else None,
        "stall_share_prefetch": stall_pf,
        "stall_share_sync": stall_sync,
        "n": n, "batch": batch, "image": image, "workers": workers,
        "backend": "gpu" if cuda else "cpu",
        "codec": f"PIL {PIL.__version__}",
        "impl": "torch",
        "device_name": torch.cuda.get_device_name(dev) if cuda else None,
        "nvidia_smi": card_line() if cuda else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image", type=int, default=32)
    ap.add_argument("--workers", type=int, default=2)
    args = ap.parse_args(argv)
    try:
        res = run(args.n, args.batch, args.image, args.workers)
    except ImportError as err:
        raise SystemExit(f"bench_input_pipeline: no image codec ({err}); "
                         "it needs PIL") from err
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
