#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one CUDA card, end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises, exits non-zero and prints no result line:

1. Card report (name, count, power limit); TF32 off for matmuls and cuDNN.
2. Build every kernel from the checkout's sources (one nvcc per source,
   all started together); print build seconds and the ptxas register,
   shared-memory and spill lines.
3. The forward kernel against its plain PyTorch version on the card, at
   the serving path's shape (4, 12, 1024, 64), causal and not, f32 and
   bf16, plus a ragged T=1000; max abs and rel error beside the
   tolerance.
3b. The backward kernels (dQ, dK/dV) against their plain version at the
   training path's shape (8, 12, 1024, 64), causal and not, f32 and bf16,
   plus a ragged T=1000, with dO random and O, L from the forward kernel
   (itself checked there against its plain version).
4. Forward timing with CUDA events: kernel, plain version, the PyTorch
   library call as a yardstick (the port never calls it), and the bound
   reckoned from shapes.
4b. Backward timing at (8, 12, 1024, 64) causal, f32 and bf16: each
   kernel, their sum, the plain backward, the bounds, and the backward of
   F.scaled_dot_product_attention as a yardstick.
5. The serving path at GPT-2 small's full width (random f32 weights from
   a numpy seed, loaded through convert.load_state): (a) generate() over
   the flash trunk, with the kernel's launch count checked; (b) the
   ServingEngine agrees with (a); (c) a coalesced mixed-length group
   equals the same prompts served one by one; (d) the flash trunk's
   logits agree with the dense trunk's.
5e. The training path at full width: ShardedTrainer(adamw) on
   gpt2_small(scan_layers=True, attention_impl="flash", dropout=0.0) at
   B=8, T=1024 on the permutation corpus of
   examples/gpt_pretrain_sharded.py: (i) loss and every gradient against a
   dense trunk's at B=2; (ii) one step launches each kernel once per
   layer; (iii) 20 steps, loss falls, ms per step; (iv) 3 bf16 steps;
   (v) the trained weights through state_for_serving into
   ServingEngine.reload_from_state agree with generate().
5f. Where a training step's device time goes: three f32 steps under
   torch.profiler, kernel time by family, and the device's busy share.
6. The kernel JSON line, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
SHAPE = (4, 12, 1024, 64)          # (B, H, T, D) of GPT-2 small at B=4
TRAIN_SHAPE = (8, 12, 1024, 64)    # ... at the training batch, B=8
TRAIN_STEPS = 20
NEW_TOKENS = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,    # FMA units: TF32 is off
              "bfloat16": 989e12}  # dense tensor cores
# f32: as the JAX package's flash tests.  bf16: each version rounds P to
# bf16 relative to its running row maximum, and the kernel's 32-key tiles
# reach other maxima than the plain version's 128-key tiles, so each
# rounded p_j may differ by 2^-8 relative: O may differ by
# 2^-8 * sum_j p_j |v_j| / l (the plain version run on |v|), plus one bf16
# step of O itself (2^-7 relative).  Two tilings of the plain version on
# the CPU differ the same way and stay within half this bound.
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2 ** -7, 1e-6)}
P_ROUND = 2 ** -8
LSE_TOL = (2e-4, 2e-5)             # LSE is f32 arithmetic in both types
# Greedy paths that sum in different orders (flash over the full window,
# dense attention over the cache, batch-size-dependent GEMM tiling) may
# only part ways at a near-tie: the top-2 logit gap there must be below
# this (f32 logits differ by ~1e-5 between the paths).
TIE_GAP = 1e-3
# Flash and dense trunks over 12 f32 layers: attention sums differ in
# order; logits are O(1).
TRUNK_TOL = (1e-3, 1e-3)
# Backward kernels against their plain version.  f32: the JAX package's
# gradient tolerance (tests/test_parallel.py:346-348).  bf16: both versions
# round P and dS to bf16 before their products, from f32 values summed in
# different orders, so a rounding may tip: each term of a sum may differ
# by one bf16 step (2^-7 relative), so a gradient by at most 2^-7 times the
# sum of |term| behind it (``bwd_magnitudes``), plus one bf16 step of the
# stored gradient.  tests/test_torch_kernels_gpu.py states the same.
BWD_TOL = {"float32": (2e-3, 2e-4), "bfloat16": (2 ** -7, 1e-6)}
BF16_STEP = 2 ** -7
# Flash and dense trunks' gradients at B=2 over 12 f32 layers: relative L2
# error per parameter (attention sums differ in order only).
GRAD_REL_L2 = 1e-3
LOSS_RTOL = 1e-5


def log(*args):
    print(*args, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def errors(got, want, rtol, atol):
    """(max abs err, max rel err, max of err / tolerance); ``atol`` may
    be a tensor of per-element tolerances."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    ratio = diff / (atol + rtol * want.abs())
    return float(diff.max()), float(rel.max()), float(ratio.max())


def bound(flops, nbytes, dtype):
    """Least time (ms) for ``flops`` operations and ``nbytes`` of device
    memory traffic, and which of the two bounds it."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# (flops per visible (query, key) pair in units of D, (B, H, T, D)
# tensors moved, f32 (B*H, T) rows moved) of each function: each input
# read once and each output written once
WORK = {
    "fwd": (4, 4, 1),    # QK^T, PV; q, k, v -> O, LSE
    "dq": (6, 6, 2),     # QK^T, dO V^T, dS K; q, k, v, O, dO, L -> dQ, D
    "dkv": (8, 6, 2),    # QK^T, dO V^T, P^T dO, dS^T Q; q, k, v, dO, L, D
                         # -> dK, dV
    "bwd": (10, 8, 1),   # the whole backward: QK^T, dO V^T, dQ, dK, dV;
                         # q, k, v, O, dO, L -> dQ, dK, dV
}


def flash_bound(B, H, T, D, causal, dtype, fn="fwd"):
    """Least time (ms) for ``fn``'s work at this shape, and what bounds
    it (``WORK`` gives the counts)."""
    per_pair, tensors, rows = WORK[fn]
    elem = 4 if dtype == "float32" else 2
    nbytes = tensors * B * H * T * D * elem + rows * B * H * T * 4
    pairs = T * (T + 1) // 2 if causal else T * T
    return bound(per_pair * D * B * H * pairs, nbytes, dtype)


def phase_kernels(dev):
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    for T in (SHAPE[2], 1000):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in ((True, False) if T == SHAPE[2] else (True,)):
                g = torch.Generator(device=dev).manual_seed(SEED + T)
                q, k, v = (torch.randn(SHAPE[:2] + (T, SHAPE[3]),
                                       device=dev, generator=g).to(dtype)
                           for _ in range(3))
                got, got_lse = fa.flash_attention_fwd(q, k, v, causal)
                want, want_lse = fa.flash_attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                name = str(dtype).split(".")[1]
                rtol, atol = TOL[name]
                tol_note = f"rtol {rtol:.2e} atol {atol:.0e}"
                if dtype == torch.bfloat16:
                    mag, _ = fa.flash_attention_plain(q, k, v.abs(), causal)
                    atol = atol + P_ROUND * mag.double()
                    tol_note += " + 2^-8 * plain(q, k, |v|)"
                o_abs, o_rel, o_ratio = errors(got, want, rtol, atol)
                l_abs, l_rel, l_ratio = errors(got_lse, want_lse, *LSE_TOL)
                finite = bool(torch.isfinite(got.float()).all())
                log(f"  T={T} {name:8s} causal={causal!s:5s}  O max abs "
                    f"{o_abs:.3e} rel {o_rel:.3e}, err/tol {o_ratio:.3f} "
                    f"({tol_note})  LSE max abs {l_abs:.3e} rel {l_rel:.3e}, "
                    f"err/tol {l_ratio:.3f} (rtol {LSE_TOL[0]:.0e} atol "
                    f"{LSE_TOL[1]:.0e})")
                if not (o_ratio <= 1 and l_ratio <= 1 and finite):
                    raise AssertionError(
                        f"flash_attention_fwd disagrees with its plain "
                        f"version at T={T} {name} causal={causal}")


def phase_timing(dev):
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    B, H, T, D = SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            g = torch.Generator(device=dev).manual_seed(SEED)
            q, k, v = (torch.randn(SHAPE, device=dev, generator=g).to(dtype)
                       for _ in range(3))
            name = str(dtype).split(".")[1]
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), 50)
            plain = cuda_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal), 5, 1)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), 50)
            bound, by = flash_bound(B, H, T, D, causal, name)
            log(f"  {SHAPE} {name:8s} causal={causal!s:5s}  kernel "
                f"{ms:.4f} ms  plain {plain:.4f} ms  sdpa {lib:.4f} ms  "
                f"bound {bound:.4f} ms ({by})  kernel/bound "
                f"{ms / bound:.1f}x")


def bwd_magnitudes(q, k, v, o, lse, do, causal):
    """Dense f32 sums of |term| behind dQ, dK and dV, with |dS| bounded by
    P * (|dO| |V|^T + |D|) * scale: the bf16 tolerance's scale."""
    import torch

    B, H, T, D = q.shape
    scale = D ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
    p = torch.exp(s - lse.reshape(B, H, T, 1)).masked_fill(s <= -5e29, 0.0)
    del s
    delta = (gf * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf.abs(), vf.abs().transpose(-1, -2))
              + delta.abs()) * scale
    return (torch.matmul(ds, kf.abs()),
            torch.matmul(p.transpose(-1, -2), gf.abs()),
            torch.matmul(ds.transpose(-1, -2), qf.abs()))


def phase_bwd_kernels(dev):
    """[3b] dQ and dK/dV kernels against flash_attention_bwd_plain; the
    forward kernel's O and L (the backward's inputs) against the plain
    forward too.  Returns max abs errors by (what, T, dtype, causal)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    B, H, T0, D = TRAIN_SHAPE
    results = {}
    for T in (T0, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in ((True, False) if T == T0 else (True,)):
                name = str(dtype).split(".")[1]
                g = torch.Generator(device=dev).manual_seed(SEED + 7 + T)
                q, k, v, do = (torch.randn((B, H, T, D), device=dev,
                                           generator=g).to(dtype)
                               for _ in range(4))
                o, lse = fa.flash_attention_fwd(q, k, v, causal)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal)
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
                want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal)
                torch.cuda.synchronize()
                rtol, atol = BWD_TOL[name]
                note = f"rtol {rtol:.2e} atol {atol:.0e}"
                mags = (bwd_magnitudes(q, k, v, o, lse, do, causal)
                        if dtype == torch.bfloat16 else (0.0,) * 3)
                if dtype == torch.bfloat16:
                    note += " + 2^-7 * sum|term|"
                line, ok = [], True
                for gname, a, b, m in zip(("dQ", "dK", "dV"), got, want,
                                          mags):
                    tol_a = atol + BF16_STEP * m \
                        if dtype == torch.bfloat16 else atol
                    e_abs, e_rel, ratio = errors(a, b, rtol, tol_a)
                    ok &= ratio <= 1 and bool(torch.isfinite(a.float()).all())
                    line.append(f"{gname} max abs {e_abs:.3e} rel "
                                f"{e_rel:.3e} err/tol {ratio:.3f}")
                    results[(gname, T, name, causal)] = e_abs
                del mags
                f_abs = float((o.float() - o_ref.float()).abs().max())
                l_abs = float((lse - lse_ref).abs().max())
                results[("O", T, name, causal)] = f_abs
                log(f"  T={T} {name:8s} causal={causal!s:5s}  "
                    + "; ".join(line) + f"  ({note}); forward O max abs "
                    f"{f_abs:.3e}, LSE {l_abs:.3e}")
                if not ok:
                    raise AssertionError(
                        f"backward kernels disagree with their plain version "
                        f"at T={T} {name} causal={causal}")
                del q, k, v, do, o, lse, o_ref, lse_ref, got, want
                torch.cuda.empty_cache()
    return results


def phase_bwd_timing(dev):
    """[4b] each backward kernel, the plain backward, the bounds and the
    SDPA backward yardstick, plus the forward at the training shape."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    B, H, T, D = TRAIN_SHAPE
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        g = torch.Generator(device=dev).manual_seed(SEED + 11)
        q, k, v, do = (torch.randn(TRAIN_SHAPE, device=dev,
                                   generator=g).to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        _, delta = fa.flash_attention_dq(q, k, v, o, lse, do, True)
        t_fwd = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 20)
        t_dq = cuda_ms(lambda: fa.flash_attention_dq(q, k, v, o, lse, do,
                                                     True), 20)
        t_dkv = cuda_ms(lambda: fa.flash_attention_dkv(q, k, v, lse, do,
                                                       delta, True), 20)
        plain_fwd = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                            3, 1)
        plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, True), 3, 1)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 20)
        b = {fn: flash_bound(B, H, T, D, True, name, fn)
             for fn in ("fwd", "dq", "dkv", "bwd")}
        rows[name] = {"fwd": t_fwd, "dq": t_dq, "dkv": t_dkv,
                      "plain_fwd": plain_fwd, "plain_bwd": plain_bwd,
                      "lib_fwd": lib_fwd, "lib_bwd": lib_bwd, "bound": b}
        log(f"  {TRAIN_SHAPE} {name:8s} causal  dQ kernel {t_dq:.4f} ms "
            f"(bound {b['dq'][0]:.4f}, {b['dq'][1]})  dK/dV kernel "
            f"{t_dkv:.4f} ms (bound {b['dkv'][0]:.4f}, {b['dkv'][1]})  sum "
            f"{t_dq + t_dkv:.4f} ms against the backward's bound "
            f"{b['bwd'][0]:.4f} ms ({b['bwd'][1]}; sum/bound "
            f"{(t_dq + t_dkv) / b['bwd'][0]:.1f}x)  plain backward "
            f"{plain_bwd:.4f} ms  sdpa backward {lib_bwd:.4f} ms")
        log(f"  {TRAIN_SHAPE} {name:8s} causal  forward kernel {t_fwd:.4f} "
            f"ms (bound {b['fwd'][0]:.4f}, {b['fwd'][1]})  plain "
            f"{plain_fwd:.4f} ms  sdpa {lib_fwd:.4f} ms")
        del q, k, v, do, o, lse, delta, qg, kg, vg, out
        torch.cuda.empty_cache()
    return rows


def _numpy_state(model, rng):
    """A serving checkpoint in the JAX package's naming, with random f32
    values at the model's shapes."""
    import numpy as np

    state = {}
    for name, p in model.named_parameters():
        short = name.split(".")[-1]
        key = ("gptmodel0_trunk_" if name.startswith("encoder.")
               else "gptmodel0_") + short
        a = rng.standard_normal(tuple(p.shape), dtype=np.float32) * 0.02
        if short.endswith("gamma"):
            a += 1.0
        state[key] = a
    return state


def _top2_gap(model, prefix):
    """Top-2 logit gap at the last position of a (1, T) prefix."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo.gpt import _windowed_last_logits

    with torch.inference_mode():
        top = _windowed_last_logits(model, prefix).topk(2, dim=-1).values
    return float(top[0, 0] - top[0, 1])


def _agree(model, prompts, ref, got, what):
    """Token rows must be equal, or part ways only at a near-tie of the
    reference model's logits."""
    import torch

    for i, (a, b) in enumerate(zip(ref, got)):
        diff = [j for j in range(len(a)) if int(a[j]) != int(b[j])]
        if not diff:
            continue
        j = diff[0]
        prefix = torch.as_tensor(list(prompts[i]) + [int(t) for t in a[:j]],
                                 device=model.tok_embed_weight.device)
        gap = _top2_gap(model, prefix[None])
        log(f"  {what}: request {i} parts at step {j}, top-2 gap {gap:.3e} "
            f"(tol {TIE_GAP:.0e})")
        if gap >= TIE_GAP:
            raise AssertionError(f"{what}: request {i} differs at step {j} "
                                 f"with a top-2 gap of {gap}")
    same = all(len(a) == len(b) and all(int(x) == int(y)
                                        for x, y in zip(a, b))
               for a, b in zip(ref, got))
    log(f"  {what}: tokens identical: {same}")


def phase_main_path(dev, card):
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(SEED)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash")
    if model.tok_embed_weight.device != dev:
        raise AssertionError(f"gpt2_small() landed on "
                             f"{model.tok_embed_weight.device}, not {dev}")
    state = _numpy_state(model, rng)
    convert.load_state(model, state)
    L = model.encoder._num_layers
    vocab = model._vocab
    prompts = rng.integers(0, vocab, (4, 64))

    gpt.generate(model, prompts, max_new_tokens=1)       # warm-up
    torch.cuda.synchronize()
    # (a) the main path: every kernel count from 0, read right after
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    toks = gpt.generate(model, prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    out_a = toks[:, 64:].cpu().numpy()
    log(f"  (a) generate: 4 x 64-token prompts, {NEW_TOKENS} new tokens: "
        f"{t_gen * 1e3:.1f} ms, {t_gen / NEW_TOKENS * 1e3:.2f} ms per step "
        f"(full {model._max_length}-token window), "
        f"{4 * NEW_TOKENS / t_gen:.1f} tokens/s  [{card}]")
    log(f"      flash_attention_fwd launches: {launches} (want {L} x "
        f"{NEW_TOKENS} = {L * NEW_TOKENS})")
    if launches != L * NEW_TOKENS:
        raise AssertionError("generate() did not launch the kernel once per "
                             "layer per token")
    if toks.shape != (4, 64 + NEW_TOKENS) or not (
            (out_a >= 0) & (out_a < vocab)).all():
        raise AssertionError(f"generate() returned {tuple(toks.shape)} "
                             f"tokens outside the vocabulary")

    # (b) the serving engine on the same weights and prompts
    eng = ServingEngine(model, batch_buckets=(1, 2, 4))
    eng.serve_group([prompts[0]], 1)                      # warm-up
    before = fa.flash_attention_fwd.launches
    outs, tm = eng.serve_group(list(prompts), NEW_TOKENS)
    log(f"  (b) ServingEngine: prefill {tm['prefill_us'] / 1e3:.2f} ms, "
        f"decode {tm['decode_us_per_token'] / 1e3:.2f} ms per token, "
        f"bucket {tm['bucket']}, "
        f"{4 * NEW_TOKENS / ((tm['prefill_us'] + tm['decode_us']) / 1e6):.1f}"
        f" tokens/s  [{card}]  (flash launches: "
        f"{fa.flash_attention_fwd.launches - before}; the engine's "
        f"attention is dense over its cache)")
    _agree(model, prompts, out_a, outs, "(b) engine vs generate")

    # (c) a coalesced mixed-length group against one-by-one serving
    lens = (17, 64, 200, 511)
    mixed = [rng.integers(0, vocab, n) for n in lens]
    grouped, tg = eng.serve_group(mixed, NEW_TOKENS)
    solo = [eng.serve_group([p], NEW_TOKENS)[0][0] for p in mixed]
    log(f"  (c) coalesced group of {lens}: bucket {tg['bucket']}, prefill "
        f"{tg['prefill_us'] / 1e3:.2f} ms, decode "
        f"{tg['decode_us_per_token'] / 1e3:.2f} ms per token  [{card}]")
    _agree(model, mixed, solo, grouped, "(c) coalesced vs one-by-one")

    # (d) flash trunk against the dense trunk at the full window
    dense = gpt.gpt2_small(scan_layers=True, attention_impl="dense")
    convert.load_state(dense, state)
    ids = torch.as_tensor(rng.integers(0, vocab, (1, model._max_length)),
                          device=dev)
    with torch.inference_mode():
        lf, ld = model(ids), dense(ids)
    torch.cuda.synchronize()
    d_abs, d_rel, d_ratio = errors(lf, ld, *TRUNK_TOL)
    finite = bool(torch.isfinite(lf).all())
    log(f"  (d) flash vs dense trunk logits {tuple(lf.shape)}: max abs "
        f"{d_abs:.3e} rel {d_rel:.3e}, err/tol {d_ratio:.3f} (rtol "
        f"{TRUNK_TOL[0]:.0e} atol {TRUNK_TOL[1]:.0e}), finite {finite}")
    if not (d_ratio <= 1 and finite):
        raise AssertionError("flash trunk disagrees with the dense trunk")
    return launches


def _corpus(rng, B, T, vocab):
    """examples/gpt_pretrain_sharded.py's synthetic corpus with learnable
    structure: tok_{t+1} = perm[tok_t]."""
    import numpy as np

    perm = rng.permutation(vocab)
    seqs = [rng.integers(0, vocab, (B,))]
    for _ in range(T - 1):
        seqs.append(perm[seqs[-1]])
    return np.stack(seqs, axis=1).astype(np.int64)


def _loss_and_grads(model, ids):
    """The LM loss and every parameter's gradient, in training mode (the
    models here have no dropout, so it is deterministic)."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import gpt

    model.train()
    try:
        loss = gpt.GPTLMLoss()(model(ids), ids)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        model.eval()
    return float(loss.detach()), dict(zip(names, grads))


def _counts():
    from mxnet_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_dq": fa.flash_attention_dq.launches,
            "flash_attention_dkv": fa.flash_attention_dkv.launches}


def _zero_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0


def phase_train(dev, card):
    """[5e] The training path at GPT-2 small's full width.  Returns the
    kernel launches of one ShardedTrainer step."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.serving import ServingEngine, state_for_serving

    B, H, T, _ = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 5)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                           dropout=0.0)
    state = _numpy_state(model, rng)
    convert.load_state(model, state)
    dense = gpt.gpt2_small(scan_layers=True, attention_impl="dense",
                           dropout=0.0)
    convert.load_state(dense, state)
    L, vocab = model.encoder._num_layers, model._vocab
    ids = torch.as_tensor(_corpus(rng, B, T, vocab), device=dev)

    # (i) loss and every gradient, flash trunk against dense trunk, B=2
    lf, gf = _loss_and_grads(model, ids[:2])
    ld, gd = _loss_and_grads(dense, ids[:2])
    worst = max(((float((gf[n] - gd[n]).norm() / gd[n].norm()), n)
                 for n in gd), key=lambda x: x[0])
    finite = all(bool(torch.isfinite(g).all()) for g in gf.values())
    log(f"  (i) B=2 loss flash {lf:.6f} dense {ld:.6f} (rel diff "
        f"{abs(lf - ld) / abs(ld):.2e}, tol {LOSS_RTOL:.0e}); largest "
        f"per-parameter gradient rel L2 error {worst[0]:.3e} ({worst[1]}; "
        f"tol {GRAD_REL_L2:.0e}) over {len(gd)} parameters; finite "
        f"{finite}")
    if not (abs(lf - ld) <= LOSS_RTOL * abs(ld) and worst[0] <= GRAD_REL_L2
            and finite):
        raise AssertionError("flash trunk's loss or gradients disagree with "
                             "the dense trunk's")
    del gf, gd
    torch.cuda.empty_cache()

    # (ii) one trainer step: each kernel once per layer
    trainer = ShardedTrainer(model, gpt.GPTLMLoss(), "adamw",
                             {"learning_rate": 3e-4})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses = [float(trainer.step(ids, ids))]
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  (ii) one ShardedTrainer.step at B={B}, T={T}: launches "
        f"{launches} (want {L} each); peak device memory {peak:.2f} GiB")
    if any(n != L for n in launches.values()):
        raise AssertionError("a train step did not launch each flash kernel "
                             "once per layer")

    # (iii) the rest of the 20 steps: the loss falls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(trainer.step(ids, ids)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (TRAIN_STEPS - 1) * 1e3
    log(f"  (iii) {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (every 5th: "
        f"{[round(x, 4) for x in losses[::5]]}); {ms:.2f} ms per step, "
        f"{B * T / ms * 1e3:.0f} tokens/s (steps 2-{TRAIN_STEPS}, f32, TF32 "
        f"off)  [{card}]")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")

    # (iv) the model cast to bf16: three finite steps
    bf = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                        dropout=0.0)
    convert.load_state(bf, state)
    bf.to(torch.bfloat16)
    btr = ShardedTrainer(bf, gpt.GPTLMLoss(), "adamw",
                         {"learning_rate": 3e-4})
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bl = [float(btr.step(ids, ids)) for _ in range(3)]
    torch.cuda.synchronize()
    bms = (time.perf_counter() - t0) / 3 * 1e3
    dtypes = {p.dtype for p in bf.parameters()}
    after = _counts()
    log(f"  (iv) bf16: losses {[round(x, 4) for x in bl]}, {bms:.2f} ms per "
        f"step (first included), parameters {sorted(map(str, dtypes))}, "
        f"kernel launches {({k: after[k] - before[k] for k in after})}")
    if not (all(np.isfinite(bl)) and dtypes == {torch.bfloat16}):
        raise AssertionError(f"bf16 training failed: {bl}, {dtypes}")
    del bf, btr
    torch.cuda.empty_cache()

    # (v) the trained weights through the serving checkpoint into an engine
    # that served the untrained ones
    eng = ServingEngine(dense, batch_buckets=(2,))
    eng.reload_from_state(state_for_serving(model))
    plen = min(64, model._max_length // 2)
    prompts = rng.integers(0, vocab, (2, plen))
    ref = gpt.generate(model, prompts, max_new_tokens=NEW_TOKENS)
    outs, _ = eng.serve_group(list(prompts), NEW_TOKENS)
    log(f"  (v) engine generation {eng.generation} after "
        f"reload_from_state(state_for_serving(trained model))")
    _agree(model, prompts, ref[:, plen:].cpu().numpy(), outs,
           "(v) engine after reload vs generate() on the trained model")
    return launches, ms


# kernel-name fragments -> family, first match wins
FAMILIES = (("flash_dq", "flash dQ kernel"),
            ("flash_dkv", "flash dK/dV kernel"),
            ("flash_fwd", "flash forward kernel"),
            ("gemm", "GEMM"), ("gemv", "GEMM"), ("cutlass", "GEMM"),
            ("softmax", "softmax / log-softmax"),
            ("reduce", "reductions"), ("elementwise", "elementwise"),
            ("vectorized", "elementwise"), ("index", "gather / scatter"),
            ("scatter", "gather / scatter"), ("gather", "gather / scatter"),
            ("copy", "copies"), ("cat", "copies"))


def phase_profile(dev, card, steps=3):
    """[5f] torch.profiler over ``steps`` f32 ShardedTrainer steps at the
    training shape: device time by kernel family, host wall time, and the
    device's busy share (its kernel time over the wall time)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.parallel import ShardedTrainer

    B, _, T, _ = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 5)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                           dropout=0.0)
    convert.load_state(model, _numpy_state(model, rng))
    ids = torch.as_tensor(_corpus(rng, B, T, model._vocab), device=dev)
    trainer = ShardedTrainer(model, gpt.GPTLMLoss(), "adamw",
                             {"learning_rate": 3e-4})
    for _ in range(2):
        trainer.step(ids, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(ids, ids)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    fam, names = {}, {}
    for evt in prof.key_averages():
        # kernels only: a CPU op's entry repeats its kernels' device time
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if not dev_us:
            continue
        key = evt.key.lower()
        f = next((v for k, v in FAMILIES if k in key), "other")
        fam[f] = fam.get(f, 0.0) + dev_us / 1e3 / steps
        names[evt.key] = dev_us / 1e3 / steps
    busy = sum(fam.values())
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    log(f"  {steps} f32 steps at B={B}, T={T}: host wall {wall:.2f} ms per "
        f"step, device kernel time {busy:.2f} ms per step, busy share "
        f"{busy / wall:.3f}  [{card}]")
    for f, ms in sorted(fam.items(), key=lambda x: -x[1]):
        log(f"    {f:24s} {ms:9.3f} ms per step  {ms / busy:6.1%}")
    log("    top kernels:")
    for k, ms in sorted(names.items(), key=lambda x: -x[1])[:12]:
        log(f"      {ms:9.3f} ms  {k[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mxnet_tpu_torch import _kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = smi_line()
    log("[1] card:", torch.cuda.get_device_name(0), "| count",
        torch.cuda.device_count(), "| nvidia-smi:", card)
    log("    torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("    TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    log("[2] build")
    t0 = time.perf_counter()
    secs = _kernels.build()
    log(f"    built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: { {k: round(v, 1) for k, v in secs.items()} })")
    for name, lines in _kernels.PTXAS_LOG.items():
        for ln in lines:
            log(f"    {name}: {ln.strip()}")

    log("[3] forward kernel against its plain version")
    phase_kernels(dev)

    log("[3b] backward kernels against their plain version")
    bwd_errs = phase_bwd_kernels(dev)

    log("[4] forward timing (CUDA events)  [" + card + "]")
    phase_timing(dev)

    log("[4b] backward timing (CUDA events)  [" + card + "]")
    bwd_rows = phase_bwd_timing(dev)

    log("[5] serving path: gpt2_small, flash trunk, full width")
    _zero_counts()
    gen_launches = phase_main_path(dev, card)

    log("[5e] training path: gpt2_small, flash trunk, ShardedTrainer, "
        "full width")
    train_launches, step_ms = phase_train(dev, card)

    f32 = bwd_rows["float32"]
    T0 = TRAIN_SHAPE[2]
    sources = {"fwd": ("flash_attention_fwd", "flash_attention_fwd.cu",
                       ":78", "lib_fwd", "plain_fwd"),
               "dq": ("flash_attention_dq", "flash_attention_bwd.cu", ":190",
                      "lib_bwd", "plain_bwd"),
               "dkv": ("flash_attention_dkv", "flash_attention_bwd.cu",
                       ":241", "lib_bwd", "plain_bwd")}
    errs_by = {"fwd": bwd_errs[("O", T0, "float32", True)],
               "dq": bwd_errs[("dQ", T0, "float32", True)],
               "dkv": max(bwd_errs[("dK", T0, "float32", True)],
                          bwd_errs[("dV", T0, "float32", True)])}
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"mxnet_tpu_torch/csrc/{src}",
        "replaces": f"mxnet_tpu/ops/pallas_attention.py{line}",
        "launches": train_launches[name],
        "max_abs_err": errs_by[fn],
        "ms": f32[fn],
        "plain_ms": f32[plain],
        "bound_ms": f32["bound"][fn][0],
        "bound_by": f32["bound"][fn][1],
        "library_ms": f32[lib],
        "shape": f"{TRAIN_SHAPE} float32 causal",
        "launches_by_path": ({"generate": gen_launches,
                              "train_step": train_launches[name]}
                             if fn == "fwd" else
                             {"train_step": train_launches[name]}),
        "plain_and_library_cover": ("the forward" if fn == "fwd" else
                                    "the whole backward (dQ, dK, dV)"),
    } for fn, (name, src, line, lib, plain) in sources.items()]}
    log("[5f] where a training step's device time goes (torch.profiler)")
    phase_profile(dev, card)

    log(f"[6] done in {time.perf_counter() - t_start:.1f} s "
        f"(train step {step_ms:.2f} ms)")
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
