"""Bucketed KV-cache serving engine for the decoder-only model zoo.

Counterpart of ``mxnet_tpu/serving/engine.py::ServingEngine`` on one
device, without a mesh.  It keeps the JAX engine's contract:

- requests are padded to the nearest (batch bucket, prefill bucket);
  one prefill step over the padded prompts, then one S=1 decode step per
  generated token, with greedy or temperature sampling;
- the key/value cache is stage-major (L, B, H, W, Dh), matching the
  ``*_stack_*`` weight stacks; each row carries its own write position
  and its own causal mask, so a coalesced batch may mix prompt lengths
  and pad rows never leak into real rows;
- weights are swapped under a lock by ``reload_from_state``, the
  serving-checkpoint convention that ``state_for_serving`` writes (so a
  model trained by the port goes straight to the engine);
- ``dtype=torch.bfloat16`` keeps the weight matrices, embedding tables
  and cache in bf16 while LayerNorm, biases and every reduction stay f32.

PyTorch runs eagerly, so the JAX engine's ahead-of-time programs and
their trace counters have no counterpart; the cache is updated in place
rather than donated.  CUDA graphs per bucket, the telemetry events and
``expect_fp`` integrity checks come with later slices.  Attention here
is dense over the cache window (as in the JAX engine): the step reaches
no kernel.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..base import MXNetError
from ..convert import as_tensor, match_state
from ..gluon.model_zoo.gpt import (STACK_NAMES, _model_device, _sample,
                                   extract_decoder_stacks)
from ..ops.nn import activation, layer_norm

_NEG = -1e30
# the big tensors the serving dtype applies to
_MATRICES = ("qkv_stack_weight", "proj_stack_weight", "ffn1_stack_weight",
             "ffn2_stack_weight")


def batch_buckets_from_env(default=(1, 2, 4, 8)):
    """MXTPU_SERVE_BUCKETS: comma-separated ascending batch buckets."""
    raw = os.environ.get("MXTPU_SERVE_BUCKETS")
    if not raw:
        return tuple(default)
    try:
        buckets = tuple(sorted({int(x) for x in raw.split(",") if x}))
    except ValueError:
        return tuple(default)
    return buckets or tuple(default)


def prefill_buckets_for(window, floor=8):
    """Power-of-two prefill sequence buckets up to the cache window."""
    buckets, s = [], max(1, floor)
    while s < window:
        buckets.append(s)
        s *= 2
    buckets.append(window)
    return tuple(buckets)


def state_for_serving(model):
    """Flat host state ``{param_name: np.ndarray}`` of a port model by
    Gluon name (its ``collect_params()``), the serving-checkpoint
    convention that ``convert.load_state`` and
    ``ServingEngine.reload_from_state`` read (matched by name suffix, so
    a scanned-trunk model's).  Arrays are float32 copies: numpy has no
    bfloat16."""
    return {name: p.data()._data.detach().to("cpu", torch.float32)
            .numpy().copy() for name, p in model.collect_params().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Bucketed prefill/decode over a port ``GPTModel``'s weight stacks,
    pulled from either trunk layout by ``gpt.extract_decoder_stacks``.

    ``serve_group(prompts, max_new_tokens)`` is the whole request path;
    the engine runs on the model's device."""

    def __init__(self, model, batch_buckets=None, prefill_floor=8,
                 dtype=None):
        stacks, lnf, tok, pos, heads, act = extract_decoder_stacks(model)
        self._W = model._max_length
        self._dtype = dtype
        self._device = _model_device(model)
        self.batch_buckets = tuple(sorted(
            batch_buckets if batch_buckets is not None
            else batch_buckets_from_env()))
        self.prefill_buckets = prefill_buckets_for(self._W,
                                                   floor=prefill_floor)
        self._H = heads
        self._act = act
        self._C, self._L = model._units, stacks["qkv_stack_weight"].shape[0]
        self._reload_lock = threading.Lock()
        self.generation = 0
        self._weights = self._prepare_weights(stacks, lnf, tok, pos)

    # -- weight plumbing -------------------------------------------------------

    def _prepare_weights(self, stacks, lnf, tok, pos):
        """The engine's own copy on its device, head-major: qkv as
        (L, 3, H, Dh, C) and the projection as (L, C, H, Dh), with the
        serving dtype on the matrices and embedding tables."""
        L, H, C = self._L, self._H, self._C
        Dh = C // H

        def put(t, big=False):
            dtype = self._dtype if big and self._dtype else torch.float32
            return t.to(device=self._device, dtype=dtype, copy=True)

        s = {n: put(t, n in _MATRICES) for n, t in stacks.items()}
        return {
            "tok": put(tok, True), "pos": put(pos, True),
            "qkv": s["qkv_stack_weight"].reshape(L, 3, H, Dh, C),
            "qkv_b": s["qkv_stack_bias"].reshape(L, 3, H, Dh),
            "proj": s["proj_stack_weight"].reshape(L, C, H, Dh),
            "proj_b": s["proj_stack_bias"],
            "ffn1": s["ffn1_stack_weight"], "ffn1_b": s["ffn1_stack_bias"],
            "ffn2": s["ffn2_stack_weight"], "ffn2_b": s["ffn2_stack_bias"],
            "ln1_g": s["ln1_stack_gamma"], "ln1_b": s["ln1_stack_beta"],
            "ln2_g": s["ln2_stack_gamma"], "ln2_b": s["ln2_stack_beta"],
            "lnf_g": put(lnf[0]), "lnf_b": put(lnf[1]),
        }

    def reload_from_state(self, state):
        """Swap in weights from a serving checkpoint ``{name: np.ndarray}``
        (``state_for_serving`` convention, matched by suffix).  Shapes
        must match the served model's."""
        what = "serving reload"
        arrays = {k: as_tensor(a, k, what)
                  for k, a in match_state(state, what).items()}
        new_w = self._prepare_weights(
            {n: arrays[n] for n in STACK_NAMES},
            (arrays["lnf_gamma"], arrays["lnf_beta"]),
            arrays["tok_embed_weight"], arrays["pos_embed_weight"])
        for name, old in self._weights.items():
            new = new_w[name]
            if new.shape != old.shape:
                raise MXNetError(
                    f"{what}: weight mismatch, {name} {tuple(new.shape)} vs "
                    f"served {tuple(old.shape)}")
        with self._reload_lock:
            self._weights = new_w
            self.generation += 1

    # -- cache -----------------------------------------------------------------

    def init_cache(self, B):
        """Fresh zeroed (ck, cv) for batch bucket B: (L, B, H, W, Dh) in
        the serving dtype."""
        shape = (self._L, B, self._H, self._W, self._C // self._H)
        dtype = self._weights["tok"].dtype
        return (torch.zeros(shape, dtype=dtype, device=self._device),
                torch.zeros(shape, dtype=dtype, device=self._device))

    # -- the block step --------------------------------------------------------

    def _step(self, w, ck, cv, pos, toks):
        """ck/cv (L, B, H, W, Dh), written in place; pos (B,) per-row write
        offsets; toks (B, S).  Returns logits (B, S, vocab) f32.  S is the
        prefill bucket, or 1 for decode."""
        B, S = toks.shape
        H, W = self._H, self._W
        Dh = self._C // H
        dev = self._device
        positions = pos[:, None] + torch.arange(S, device=dev)   # (B, S)
        rows = torch.arange(B, device=dev)[:, None]
        # row b at block offset s sees cache slots <= pos[b] + s; stale pad
        # beyond is invisible (it is overwritten before it is attended)
        keep = torch.arange(W, device=dev)[None, None, :] \
            <= positions[:, :, None]                              # (B, S, W)
        x = (w["tok"][toks] + w["pos"][positions]).float()       # (B, S, C)
        for i in range(self._L):
            h = layer_norm(x, w["ln1_g"][i], w["ln1_b"][i])
            qkv = torch.einsum("bsc,thdc->bsthd", h, w["qkv"][i].float()) \
                + w["qkv_b"][i]
            qh, kh, vh = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            ck_l, cv_l = ck[i], cv[i]                             # (B,H,W,Dh)
            ck_l.transpose(1, 2)[rows, positions] = \
                kh.transpose(1, 2).to(ck_l.dtype)
            cv_l.transpose(1, 2)[rows, positions] = \
                vh.transpose(1, 2).to(cv_l.dtype)
            scores = torch.einsum("bhsd,bhwd->bhsw", qh, ck_l.float()) \
                * (Dh ** -0.5)
            scores = scores.masked_fill(~keep[:, None], _NEG)
            p = torch.softmax(scores, dim=-1)
            attn = torch.einsum("bhsw,bhwd->bhsd", p, cv_l.float())
            attn = torch.einsum("bhsd,chd->bsc", attn, w["proj"][i].float()) \
                + w["proj_b"][i]
            x = x + attn
            h = layer_norm(x, w["ln2_g"][i], w["ln2_b"][i])
            h = torch.matmul(h, w["ffn1"][i].float().t()) + w["ffn1_b"][i]
            h = activation(h, self._act)
            x = x + (torch.matmul(h, w["ffn2"][i].float().t())
                     + w["ffn2_b"][i])
        h = layer_norm(x, w["lnf_g"], w["lnf_b"])
        return torch.matmul(h, w["tok"].float().t())

    def _call(self, ck, cv, pos, toks):
        with self._reload_lock:
            w = self._weights
        return self._step(w, ck, cv, pos, toks)

    # -- request path ----------------------------------------------------------

    def _pick_bucket(self, buckets, n, what):
        for b in buckets:
            if b >= n:
                return b
        raise MXNetError(
            f"serving: {what} {n} exceeds the largest bucket "
            f"{buckets[-1]} (buckets {buckets})")

    def serve_group(self, prompts, max_new_tokens, temperature=None,
                    generator=None):
        """Serve one coalesced group.  ``prompts``: list of 1-D int
        sequences (mixed lengths OK); ``max_new_tokens``: int or one per
        request.  Returns ``(outputs, timings)``: outputs[i] is request
        i's generated tokens (np.int32), timings carries prefill_us,
        decode_us_per_token, bucket, padded_fraction, generation,
        t_prefill0, t_decode0 and decode_us."""
        n = len(prompts)
        if n == 0:
            return [], {}
        per_req = [max_new_tokens] * n \
            if isinstance(max_new_tokens, int) else list(max_new_tokens)
        if len(per_req) != n or any(k < 1 for k in per_req):
            raise MXNetError("serving: max_new_tokens must be a positive "
                             "int or one per prompt")
        steps = max(per_req)
        B = self._pick_bucket(self.batch_buckets, n, "group size")
        lens = np.ones(B, np.int64)     # pad rows hold one dummy token
        for i, p in enumerate(prompts):
            if len(p) < 1:
                raise MXNetError("serving: empty prompt")
            lens[i] = len(p)
        Tmax = int(lens[:n].max())
        if Tmax + steps > self._W:
            raise MXNetError(
                f"serving: {Tmax} prompt + {steps} new tokens exceed "
                f"the cache window max_length={self._W}")
        S = self._pick_bucket(self.prefill_buckets, Tmax, "prompt length")
        toks = np.zeros((B, S), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = np.asarray(p, np.int64)
        dev = self._device
        with torch.inference_mode():
            t0 = time.perf_counter()
            t_prefill0 = time.time()
            lens_t = torch.as_tensor(lens, device=dev)
            ck, cv = self.init_cache(B)
            logits = self._call(ck, cv, torch.zeros_like(lens_t),
                                torch.as_tensor(toks, device=dev))
            last = logits[torch.arange(B, device=dev), lens_t - 1]
            _sync(dev)
            prefill_us = (time.perf_counter() - t0) * 1e6
            t1 = time.perf_counter()
            t_decode0 = time.time()
            out = torch.zeros((B, steps), dtype=torch.int64, device=dev)
            for j in range(steps):
                nxt = _sample(last, temperature, generator)
                out[:, j] = nxt
                if j < steps - 1:     # the last token needs no cache step
                    last = self._call(ck, cv, lens_t + j, nxt[:, None])[:, 0]
            out = out.cpu().numpy().astype(np.int32)
            decode_us = (time.perf_counter() - t1) * 1e6
        timings = {
            "prefill_us": prefill_us,
            "decode_us_per_token": decode_us / max(1, steps),
            "bucket": [int(B), int(S)],
            "padded_fraction": round(
                1.0 - float(lens[:n].sum()) / float(B * S), 4),
            "generation": self.generation,
            "t_prefill0": t_prefill0,
            "t_decode0": t_decode0,
            "decode_us": decode_us,
        }
        return [out[i, :per_req[i]].copy() for i in range(n)], timings
