"""Autoregressive decode throughput: the KV-cache step against full
recompute, the port's counterpart of the JAX package's
``tools/bench_decode.py``.

    python3 -m mxnet_tpu_torch.tools.bench_decode

prints one JSON line: tokens a second and ms a token of
``CachedDecoder.decode`` in f32 and in bf16 and of ``generate()`` (which
reruns the whole max_length window a token), the speedups, whether the
f32 cached tokens equal ``generate()``'s, and the bf16 decoder's first
logits against the f32 decoder's (max |difference| over max |f32|; the
reference's bf16 tolerance is 0.05), with the card's name and power
limit.  The configuration is the reference tool's batch 8, a 16-token
seed (``RandomState(0)``) and 48 new tokens, on GPT-2 small
(``gpt2_small``, Xavier from seed 0) on the card; each path runs two
tokens first as its warm-up.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import context, initializer
from ..gluon.model_zoo import gpt
from .bench_bert import card_line

BATCH, SEED_LEN, NEW_TOKENS = 8, 16, 48


def _timed(fn):
    """Seconds of ``fn()``, whose result is read back to the host inside
    the timing, and the result."""
    t0 = time.perf_counter()
    out = fn()
    toks = (out[0] if isinstance(out, tuple) else out).asnumpy()
    return time.perf_counter() - t0, out, toks


def run(net):
    """Time the three decode paths on ``net`` (a GPTModel whose window
    holds the seed and the new tokens) and return the result line."""
    dev = gpt._model_device(net)
    ids = np.random.RandomState(0).randint(
        0, net._vocab, (BATCH, SEED_LEN))
    dec = gpt.CachedDecoder(net)
    dec_bf16 = gpt.CachedDecoder(net, dtype="bfloat16")
    dec.decode(ids, max_new_tokens=2).asnumpy()
    dec_bf16.decode(ids, max_new_tokens=2).asnumpy()
    gpt.generate(net, ids, max_new_tokens=2).asnumpy()
    dt_f32, (_, lg_f32), toks_f32 = _timed(lambda: dec.decode(
        ids, NEW_TOKENS, return_logits=True))
    dt_bf16, (_, lg_bf16), _ = _timed(lambda: dec_bf16.decode(
        ids, NEW_TOKENS, return_logits=True))
    dt_full, _, toks_full = _timed(lambda: gpt.generate(net, ids,
                                                        NEW_TOKENS))
    work = BATCH * NEW_TOKENS
    cuda = dev.type == "cuda"
    return {
        "bench": "gpt_decode",
        "config": {"batch": BATCH, "seed_len": SEED_LEN,
                   "new_tokens": NEW_TOKENS, "units": net._units,
                   "layers": net.encoder._num_layers,
                   "window": net._max_length, "vocab": net._vocab},
        "kv_cache_tokens_per_sec": work / dt_f32,
        "kv_cache_bf16_tokens_per_sec": work / dt_bf16,
        "recompute_tokens_per_sec": work / dt_full,
        "kv_cache_ms_per_token": dt_f32 / NEW_TOKENS * 1e3,
        "kv_cache_bf16_ms_per_token": dt_bf16 / NEW_TOKENS * 1e3,
        "recompute_ms_per_token": dt_full / NEW_TOKENS * 1e3,
        "speedup": dt_full / dt_f32,
        "bf16_speedup_over_f32_cache": dt_f32 / dt_bf16,
        "kv_cache_tokens_equal_recompute": bool(
            np.array_equal(toks_f32, toks_full)),
        "bf16_first_logits_err_over_scale": float(
            np.abs(lg_bf16[0] - lg_f32[0]).max() / np.abs(lg_f32[0]).max()),
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if cuda else None,
        "nvidia_smi": card_line() if cuda else None,
    }


def main():
    dev = context.resolve(None)
    net = gpt.gpt2_small(dropout=0.0, device=dev)
    net.initialize(initializer.Xavier(),
                   generator=torch.Generator(device=dev).manual_seed(0))
    print(json.dumps(run(net)), flush=True)


if __name__ == "__main__":
    main()
