"""Bucketed KV-cache serving engine for the decoder-only model zoo.

Counterpart of ``mxnet_tpu/serving/engine.py::ServingEngine`` on one
device.  It keeps the JAX engine's contract:

- **Programs a bucket, no retrace after warm-up.**  Requests are padded
  to the nearest (batch bucket, prefill bucket); one prefill step over the
  padded prompts, then one S=1 decode step a generated token, with greedy
  or temperature sampling outside the step.  Each (batch bucket, prefill
  bucket) and each (batch bucket, S=1) is one *program*, the port's
  counterpart of the JAX engine's ahead-of-time executables: on a CUDA
  device a ``torch.cuda.CUDAGraph`` recorded once (after one warm-up run
  on a side stream) and replayed a call, every graph in one shared memory
  pool (the engine replays one graph at a time, on one thread, under its
  reload lock); on the CPU the eager step.  ``compile_count`` counts
  recordings (programs built on the CPU), ``dispatch_count`` replays
  (program calls), and ``trace_count`` the runs of the step body outside
  a replay (the warm-up and the recording; the one build run on the
  CPU), so it does not move after ``warmup()``.  A graph that fails to
  record raises ``MXNetError``: the card never falls back to the eager
  step.
- **Static buffers.**  A batch bucket owns one key/value cache, stage-major
  (L, B, H, W, Dh) like the ``*_stack_*`` weight stacks, shared by its
  prefill and decode programs and zeroed at the start of each group, as
  the JAX engine starts each group from a fresh zeroed cache; its
  per-row write offsets, read positions and output logits (B, vocab) are
  static too, and each program owns its (B, S) token buffer.  Each row
  carries its own write position and causal mask, so a coalesced batch
  may mix prompt lengths and pad rows never leak into real rows.
- **Hot reload.**  ``reload_from_model`` and ``reload_from_state`` (the
  serving-checkpoint convention ``state_for_serving`` writes) check the
  new weights' shapes and dtypes, then copy them into the static weight
  tensors in place under the reload lock, which every replay holds, so
  no replay sees half of a generation; ``generation`` counts the swaps
  and each emits a ``serving_reload`` event.  ``reload_from_state``'s
  ``expect_fp`` refuses a state whose integrity fingerprint does not
  match (``serving_reload_rejected``).
- ``dtype=torch.bfloat16`` keeps the weight matrices, embedding tables
  and cache in bf16 while LayerNorm, biases and every reduction stay f32.

The step is ``gpt.decoder_step`` (shared with ``gpt.CachedDecoder``):
dense attention over the cache window, as in the JAX engine; it reaches
no kernel of the port's own.  A program returns only each row's logits at
its read position (the JAX program returns every position's and the
engine reads those).  ``mesh=`` (a rank mesh with a ``tp_axis``) serves
tensor-parallel: every rank of the tp group holds its heads and FFN
block (``gpt.decoder_weights``), its heads of each bucket's cache, and
runs the same ``serve_group`` calls, the step all-reducing twice a
layer.  A CUDA graph cannot hold a gloo collective, so over a gloo tp
group each program is the eager step on the card too (``recordings``
stays 0 and ``eager_reason`` says why); graphs over an NCCL tp group
across cards cannot be checked on one card and are refused by name.
The replicas are ``serving/replica.py``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError, torch_dtype
from ..convert import as_tensor, match_state
from ..gluon.model_zoo.gpt import (STACK_NAMES, _model_device, _sample,
                                   decoder_step, decoder_weights,
                                   extract_decoder_stacks, tp_plan)

# -- counters (the retrace-free pin) -------------------------------------------

_LOCK = threading.Lock()
_TRACE_COUNT = 0      # step-body runs outside a replay
_COMPILE_COUNT = 0    # programs recorded (built, on the CPU)
_DISPATCH_COUNT = 0   # program calls: replays on the card


def _mark_trace():
    global _TRACE_COUNT
    with _LOCK:
        _TRACE_COUNT += 1


def trace_count():
    return _TRACE_COUNT


def compile_count():
    return _COMPILE_COUNT


def dispatch_count():
    return _DISPATCH_COUNT


def reset_counters():
    global _TRACE_COUNT, _COMPILE_COUNT, _DISPATCH_COUNT
    with _LOCK:
        _TRACE_COUNT = _COMPILE_COUNT = _DISPATCH_COUNT = 0


# -- bucket policy -------------------------------------------------------------

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


class ReloadRejected(MXNetError):
    """``reload_from_state`` refused a state whose integrity fingerprint
    is not the attested one; the served weights are unchanged."""


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


class _Bucket:
    """A batch bucket's static state, shared by its programs: the cache,
    the per-row write offsets and read positions, and the logits (B,
    vocab) every program of the bucket writes."""

    def __init__(self, engine, B):
        dev = engine._device
        self.ck, self.cv = engine.init_cache(B)
        self.pos = torch.zeros(B, dtype=torch.int64, device=dev)
        self.last = torch.zeros(B, dtype=torch.int64, device=dev)
        self.out = torch.zeros((B, engine._vocab), dtype=torch.float32,
                               device=dev)


class ServingEngine:
    """Bucketed prefill/decode over a port ``GPTModel``'s weight stacks,
    pulled from either trunk layout by ``gpt.extract_decoder_stacks``.

    ``serve_group(prompts, max_new_tokens)`` is the whole request path;
    the engine runs on the model's device, each step one program
    (``warmup()`` builds them all up front)."""

    def __init__(self, model, batch_buckets=None, prefill_floor=8,
                 mesh=None, tp_axis="tp", dtype=None):
        stacks, lnf, tok, pos, heads, act = extract_decoder_stacks(model)
        self._tp = tp_plan(mesh, tp_axis, heads,
                           int(stacks["ffn1_stack_weight"].shape[1]),
                           "ServingEngine")
        self._mesh = mesh if self._tp else None
        self._tp_axis = tp_axis
        self._W = model._max_length
        self._dtype = None if dtype is None else torch_dtype(dtype)
        self._device = _model_device(model)
        self.batch_buckets = tuple(sorted(
            batch_buckets if batch_buckets is not None
            else batch_buckets_from_env()))
        self.prefill_buckets = prefill_buckets_for(self._W,
                                                   floor=prefill_floor)
        self._H = heads
        self._act = act
        self._C, self._L = model._units, stacks["qkv_stack_weight"].shape[0]
        self._vocab = tok.shape[0]
        self._reload_lock = threading.Lock()
        self.generation = 0
        self._weights = decoder_weights(stacks, lnf, tok, pos, heads,
                                        self._device, self._dtype,
                                        self._mesh, tp_axis)
        self._buckets = {}
        self._programs = {}     # (B, S) -> (token buffer, run)
        self._pool = None
        #: CUDA graphs this engine recorded, and why its programs run
        #: eagerly on the card (None when they are graphs)
        self.recordings = 0
        self.eager_reason = None
        if self._tp and self._device.type == "cuda":
            import torch.distributed as dist

            backend = dist.get_backend(self._tp[0])
            if backend == "nccl":
                raise NotImplementedError(
                    "ServingEngine(mesh=...): CUDA graphs over an NCCL tp "
                    "group span cards and cannot be checked on one card; "
                    "serve over a gloo tp group or without mesh=")
            self.eager_reason = (f"tp group over {backend}: a CUDA graph "
                                 "cannot hold its collectives")

    # -- weight plumbing -------------------------------------------------------

    def reload_from_model(self, model, step=None):
        """Swap in a live model's weights (shapes must match)."""
        stacks, lnf, tok, pos, H, act = extract_decoder_stacks(model)
        if H != self._H or act != self._act:
            raise MXNetError(
                f"serving reload: incompatible model "
                f"(heads {H} vs {self._H}, act {act!r} vs {self._act!r})")
        self._swap(stacks, lnf, tok, pos, step=step)

    def reload_from_state(self, state, step=None, expect_fp=None):
        """Swap in weights from a serving checkpoint ``{name: np.ndarray}``
        (``state_for_serving`` convention, matched by suffix).  Shapes
        must match the served model's.

        ``expect_fp``: an integrity fingerprint (u64, the training side's
        ``integrity.fingerprint_host`` of this state).  When given, the
        state is fingerprinted again here and a mismatch refuses the
        reload (a ``serving_reload_rejected`` event and
        ``ReloadRejected``),
        so the served weights stay as they were."""
        if expect_fp is not None:
            from .. import integrity

            got = integrity.fingerprint_host(state)
            if got != int(expect_fp):
                telemetry.event(
                    "serving_reload_rejected", step=step,
                    reason=f"state fingerprint {integrity.fp_hex(got)} "
                           f"!= attested "
                           f"{integrity.fp_hex(int(expect_fp))}")
                raise ReloadRejected(
                    "serving reload: restored state fingerprint does not "
                    "match the attested fingerprint; refusing to serve "
                    "corrupt weights")
        what = "serving reload"
        arrays = {k: as_tensor(a, k, what)
                  for k, a in match_state(state, what).items()}
        self._swap({n: arrays[n] for n in STACK_NAMES},
                   (arrays["lnf_gamma"], arrays["lnf_beta"]),
                   arrays["tok_embed_weight"], arrays["pos_embed_weight"],
                   step=step)

    def _swap(self, stacks, lnf, tok, pos, step=None):
        """Check the new weights against the served ones, then copy them
        into the static weight tensors (which the recorded graphs read)
        under the reload lock."""
        got = tuple(stacks["qkv_stack_weight"].shape)
        want = (self._L, 3 * self._C, self._C)
        if got != want:
            raise MXNetError(
                f"serving reload: weight mismatch, qkv stack {got} vs "
                f"served {want}")
        new_w = decoder_weights(stacks, lnf, tok, pos, self._H,
                                self._device, self._dtype, self._mesh,
                                self._tp_axis)
        for name, old in self._weights.items():
            new = new_w[name]
            if new.shape != old.shape or new.dtype != old.dtype:
                raise MXNetError(
                    f"serving reload: weight mismatch, {name} "
                    f"{tuple(new.shape)}/{new.dtype} vs served "
                    f"{tuple(old.shape)}/{old.dtype}")
        with self._reload_lock, torch.no_grad():
            for name, old in self._weights.items():
                old.copy_(new_w[name])
            self.generation += 1
            gen = self.generation
        telemetry.event("serving_reload", generation=gen, step=step)

    # -- cache -----------------------------------------------------------------

    def init_cache(self, B):
        """Fresh zeroed (ck, cv) for batch bucket B: (L, B, H, W, Dh) in
        the serving dtype."""
        H = self._weights["qkv"].shape[2]      # this rank's heads under tp
        shape = (self._L, B, H, self._W, self._C // self._H)
        dtype = self._weights["tok"].dtype
        return (torch.zeros(shape, dtype=dtype, device=self._device),
                torch.zeros(shape, dtype=dtype, device=self._device))

    def _bucket(self, B):
        bk = self._buckets.get(B)
        if bk is None:
            bk = self._buckets[B] = _Bucket(self, B)
        return bk

    # -- programs --------------------------------------------------------------

    def _body(self, bk, toks):
        """The step body a program runs: the bucket's cache advanced by
        ``toks`` at its write offsets, and each row's logits at its read
        position (position 0 for S=1) written to the bucket's output."""
        S = toks.shape[1]
        logits = decoder_step(self._weights, bk.ck, bk.cv, bk.pos, toks,
                              self._act, last=bk.last if S > 1 else None,
                              group=self._tp[0] if self._tp else None)
        bk.out.copy_(logits if S > 1 else logits[:, 0])

    def _traced_body(self, bk, toks):
        _mark_trace()
        self._body(bk, toks)

    def _record(self, bk, toks):
        """One warm-up run on a side stream, then the step recorded as a
        CUDA graph into the engine's shared pool."""
        dev = self._device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                self._traced_body(bk, toks)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                self._traced_body(bk, toks)
        except Exception as e:
            raise MXNetError(
                f"serving: recording the {tuple(toks.shape)} step as a CUDA "
                f"graph failed: {type(e).__name__}: {e}") from e
        self.recordings += 1
        return graph

    def _compile(self, B, S):
        """Program (B, S): a recorded graph on the card, the eager step
        (run once here, as the card's warm-up) on the CPU.  The build's
        runs write the bucket's cache, which each group zeroes first."""
        global _COMPILE_COUNT
        bk = self._bucket(B)
        toks = torch.zeros((B, S), dtype=torch.int64, device=self._device)
        with torch.no_grad():
            bk.pos.zero_()
            bk.last.zero_()
            if self._device.type == "cuda" and self.eager_reason is None:
                run = self._record(bk, toks).replay
            else:
                self._traced_body(bk, toks)

                def run():
                    self._body(bk, toks)
        with _LOCK:
            _COMPILE_COUNT += 1
        self._programs[(B, S)] = (toks, run)
        return toks, run

    def warmup(self):
        """Build every (batch x prefill) program and the S=1 decode
        program of each batch bucket; afterwards the request path runs no
        step body outside a replay (``trace_count()`` is pinned).  Emits
        a ``serving_warmup`` event."""
        t0 = time.perf_counter()
        for B in self.batch_buckets:
            for S in self.prefill_buckets + (1,):
                self._program(B, S)
        telemetry.event(
            "serving_warmup", programs=len(self._programs),
            compile_ms=round((time.perf_counter() - t0) * 1e3, 1))
        return self

    def program_count(self):
        return len(self._programs)

    def _program(self, B, S):
        prog = self._programs.get((B, S))
        return prog if prog is not None else self._compile(B, S)

    def _call(self, B, S, pos, toks, last=None):
        """Program (B, S), built already, on the bucket's buffers: the
        inputs copied into them and the program run under the reload
        lock.  Returns the bucket's output logits (B, vocab), valid until
        the bucket's next call."""
        global _DISPATCH_COUNT
        buf, run = self._programs[(B, S)]
        bk = self._buckets[B]
        with self._reload_lock:
            bk.pos.copy_(pos)
            buf.copy_(toks)
            if last is not None:
                bk.last.copy_(last)
            run()
        with _LOCK:
            _DISPATCH_COUNT += 1
        return bk.out

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
        with torch.no_grad():
            # both programs built before the cache is zeroed: a build's
            # runs write the cache (warmup() builds them all up front)
            self._program(B, S)
            self._program(B, 1)
            t0 = time.perf_counter()
            t_prefill0 = time.time()
            bk = self._buckets[B]
            bk.ck.zero_()
            bk.cv.zero_()
            lens_t = torch.as_tensor(lens, device=dev)
            last = self._call(B, S, torch.zeros_like(lens_t),
                              torch.as_tensor(toks), lens_t - 1)
            _sync(dev)
            prefill_us = (time.perf_counter() - t0) * 1e6
            t1 = time.perf_counter()
            t_decode0 = time.time()
            out = torch.zeros((B, steps), dtype=torch.int64, device=dev)
            for j in range(steps):
                nxt = _sample(last, temperature, generator)
                out[:, j] = nxt
                if j < steps - 1:     # the last token needs no cache step
                    last = self._call(B, 1, lens_t + j, nxt[:, None])
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
