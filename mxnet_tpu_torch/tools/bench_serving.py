"""The serving workload on one card: the port's counterpart of the JAX
package's ``bench_serving`` (``bench.py``), same configuration.

    python3 -m mxnet_tpu_torch.tools.bench_serving

prints one JSON line: ``metric`` ``serving_p50_us`` (the median request
latency under load) with ``p99_us``, ``tokens_per_sec`` (batched),
``tokens_per_sec_unbatched``, ``batched_ratio`` (the reference's gate: at
least 1), ``unbatched_p50_us``, ``retraces_after_warmup`` (the other
gate: 0), ``programs`` and ``mean_padded_fraction``, the model, the peak
memory after warm-up and the card's name and power limit as
``nvidia-smi`` reads them.

The configuration is ``bench.py``'s (``BENCH_SERVE_*`` defaults): batch
buckets (1, 2, 4, 8), 8 closed-loop clients, 24 requests of 4-16 prompt
tokens (``RandomState(1)``), 8 new tokens each, the batcher's deadline 2
ms.  The requests are served first one by one (bucket 1), then by the
clients through ``ContinuousBatcher``.  The model is GPT-2 small
(``gpt2_small(scan_layers=True)``, random weights from seed 0) in bf16
on the card, where the JAX bench runs ``gpt_tiny``: the port's bench runs
at full width.  Every request's tokens are checked to number 8.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch

from .. import context, initializer, serving
from ..gluon.model_zoo import gpt
from .bench_bert import card_line

METRIC = "serving_p50_us"
BATCH, CLIENTS, REQUESTS, NEW_TOKENS = 8, 8, 24, 8


def build(device=None):
    """The bench's engine: GPT-2 small from seed 0, bf16 on the card (f32
    on the host), every program built by ``warmup()``."""
    dev = context.resolve(device)
    net = gpt.gpt2_small(scan_layers=True, dropout=0.0, device=dev)
    net.initialize(initializer.Xavier(),
                   generator=torch.Generator(device=dev).manual_seed(0))
    buckets = tuple(sorted({1, 2, max(1, BATCH // 2), BATCH}))
    engine = serving.ServingEngine(
        net, batch_buckets=buckets,
        dtype=torch.bfloat16 if dev.type == "cuda" else None)
    return net, engine.warmup()


def run(device=None):
    """Warm up, serve the requests one by one and then through the
    batcher, and return the result line as a dict."""
    dev = context.resolve(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    net, engine = build(dev)
    traces_at_warmup = serving.trace_count()
    compiles_at_warmup = serving.compile_count()
    peak_warm = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                 if cuda else None)
    vocab = net._vocab
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, vocab, rng.randint(4, 17)).tolist()
               for _ in range(REQUESTS)]
    tokens_total = REQUESTS * NEW_TOKENS

    # unbatched: the same requests strictly one by one (bucket B=1)
    solo_lat = []
    t0 = time.perf_counter()
    for p in prompts:
        t1 = time.perf_counter()
        outs, _ = engine.serve_group([p], NEW_TOKENS)
        solo_lat.append((time.perf_counter() - t1) * 1e6)
        if len(outs[0]) != NEW_TOKENS:
            raise AssertionError(f"bench_serving: a request got "
                                 f"{len(outs[0])} tokens")
    solo_tps = tokens_total / (time.perf_counter() - t0)

    # batched: closed-loop clients through the continuous batcher
    batcher = serving.ContinuousBatcher(engine, max_delay_ms=2.0,
                                        max_batch=BATCH)
    lock = threading.Lock()
    batched_lat, padded, got, errors = [], [], [], []

    def client(idx):
        try:
            for j in range(idx, REQUESTS, CLIENTS):
                t1 = time.perf_counter()
                rec = batcher.submit(prompts[j], NEW_TOKENS).result(
                    timeout=240)
                with lock:
                    batched_lat.append((time.perf_counter() - t1) * 1e6)
                    padded.append(rec["padded_fraction"])
                    got.append(len(rec["tokens"]))
        except BaseException as e:      # reported, then raised below
            with lock:
                errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    batched_dt = time.perf_counter() - t0
    batcher.close()
    if errors:
        raise errors[0]
    if len(got) != REQUESTS or any(n != NEW_TOKENS for n in got):
        raise AssertionError(f"bench_serving: {len(got)} of {REQUESTS} "
                             f"requests served, tokens {got}")
    batched_tps = tokens_total / batched_dt
    return {
        "metric": METRIC,
        "value": float(np.percentile(batched_lat, 50)),
        "unit": "us/request",
        "p99_us": float(np.percentile(batched_lat, 99)),
        "tokens_per_sec": batched_tps,
        "tokens_per_sec_unbatched": solo_tps,
        "batched_ratio": batched_tps / solo_tps,
        "unbatched_p50_us": float(np.percentile(solo_lat, 50)),
        "retraces_after_warmup": serving.trace_count() - traces_at_warmup,
        "recordings_after_warmup":
            serving.compile_count() - compiles_at_warmup,
        "programs": engine.program_count(),
        "mean_padded_fraction": float(np.mean(padded)),
        "groups_served": batcher.groups_served,
        "clients": CLIENTS,
        "requests": REQUESTS,
        "new_tokens": NEW_TOKENS,
        "batch": BATCH,
        "model": gpt.gpt2_small.__name__,
        "dtype": str(engine._weights["tok"].dtype).split(".")[-1],
        "peak_mem_after_warmup_gib": peak_warm,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if cuda else None,
        "nvidia_smi": card_line() if cuda else None,
    }


def main():
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
