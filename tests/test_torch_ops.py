"""The port's plain PyTorch ops against the JAX package's, on the CPU,
with the same numpy inputs: LayerNorm, the trunk's GELU, dense attention
(masks, bottom-right causal for Tq != Tk), multi-head attention on its
packed and cross-attention paths, and the serving bucket policy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.serving import engine as jengine
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.serving import engine as tengine
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(0)
    x, g, b = _rand(rng, 3, 5, 48), _rand(rng, 48), _rand(rng, 48)
    want = np.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b)))
    got = tnn.layer_norm(*(torch.from_numpy(a) for a in (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the erf form is
    ~1e-3 away and would fail the trunk's parity."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tnn.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("flatten,bias", [(True, True), (False, True),
                                          (False, False)])
def test_fully_connected_matches_jax(flatten, bias):
    rng = np.random.RandomState(5)
    x, w, b = _rand(rng, 3, 4, 6), _rand(rng, 7, 24 if flatten else 6), \
        _rand(rng, 7)
    want = np.asarray(jnn.fully_connected(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None,
        flatten=flatten))
    got = tnn.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b) if bias else None,
                              flatten=flatten)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fully_connected_bf16_keeps_bf16_operands():
    """bf16 operands, an f32 accumulator, a bf16 result, as the JAX op's
    preferred_element_type=float32 then astype: the two sums differ in
    order only, so the results differ by at most one bf16 step (2^-7
    relative) where a rounding tips."""
    rng = np.random.RandomState(6)
    x, w, b = _rand(rng, 5, 64), _rand(rng, 32, 64), _rand(rng, 32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)]
    want = np.asarray(jnn.fully_connected(*jb).astype(jnp.float32))
    tb = [torch.from_numpy(a).bfloat16() for a in (x, w, b)]
    got = tnn.fully_connected(*tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_tanh_activation_matches_jax():
    x = np.linspace(-5, 5, 101).astype(np.float32)
    want = np.asarray(jnn.activation(jnp.asarray(x), act_type="tanh"))
    got = tnn.activation(torch.from_numpy(x), "tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unsupported activation"):
        tnn.activation(torch.from_numpy(x), "mish")


def test_bf16_trunk_multiplies_in_bf16():
    """Every product of a bf16 scan_transformer_encoder that takes a weight
    (qkv, projection, both FFN products) receives bf16 operands; the
    attention products on (B, H, T, D) run in f32, as in the JAX op."""
    from torch.overrides import TorchFunctionMode

    fns = {torch.matmul, torch.mm, torch.bmm, torch.addmm,
           torch.nn.functional.linear, torch.Tensor.matmul,
           torch.Tensor.__matmul__}
    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in fns:
                seen.append([(a.dtype, a.dim()) for a in args
                             if isinstance(a, torch.Tensor)])
            return func(*args, **(kwargs or {}))

    rng = np.random.RandomState(7)
    L, C, Hd = 3, 16, 32
    shapes = [(L, 3 * C, C), (L, 3 * C), (L, C, C), (L, C), (L, Hd, C),
              (L, Hd), (L, C, Hd), (L, C), (L, C), (L, C), (L, C), (L, C),
              (C,), (C,)]
    args = [torch.from_numpy(_rand(rng, *s)).bfloat16() for s in shapes]
    x = torch.from_numpy(_rand(rng, 2, 8, C)).bfloat16()
    for impl in ("dense", "flash"):
        seen.clear()
        with Record():
            out = tatt.scan_transformer_encoder(x, *args, num_heads=4,
                                                impl=impl, causal=True)
        assert out.dtype == torch.bfloat16
        weights = [ops for ops in seen if not all(d == 4 for _, d in ops)]
        assert len(weights) == 4 * L, seen
        for ops in weights:
            assert [dt for dt, _ in ops] == [torch.bfloat16] * 2, ops


@pytest.mark.parametrize("Tq,Tk,causal,masked", [
    (16, 16, True, False),
    (8, 16, True, False),       # bottom-right causal alignment
    (16, 16, False, True),
    (12, 12, True, True),
])
def test_dense_attention_matches_jax(Tq, Tk, causal, masked):
    rng = np.random.RandomState(Tq + Tk)
    q, k, v = _rand(rng, 2, 3, Tq, 8), _rand(rng, 2, 3, Tk, 8), \
        _rand(rng, 2, 3, Tk, 8)
    mask = (rng.rand(2, 1, Tq, Tk) > 0.3).astype(np.float32) \
        if masked else None
    want = np.asarray(jatt.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal))
    got = tatt.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("self_attention", [True, False])
def test_multi_head_attention_matches_jax(self_attention):
    """Packed (3C, C) qkv split q | k | v then into heads, on the fused
    self-attention path and the separate-projection path."""
    rng = np.random.RandomState(3)
    C, H = 16, 4
    x = _rand(rng, 2, 10, C)
    kv = x if self_attention else _rand(rng, 2, 10, C)
    w = [_rand(rng, 3 * C, C), _rand(rng, 3 * C), _rand(rng, C, C),
         _rand(rng, C)]
    jx, jkv = jnp.asarray(x), jnp.asarray(kv)
    want = np.asarray(jatt.multi_head_attention(
        jx, jkv if not self_attention else jx,
        jkv if not self_attention else jx,
        *(jnp.asarray(a) for a in w), num_heads=H, causal=True))
    tx, tkv = torch.from_numpy(x), torch.from_numpy(kv)
    got = tatt.multi_head_attention(
        tx, tkv if not self_attention else tx,
        tkv if not self_attention else tx,
        *(torch.from_numpy(a) for a in w), num_heads=H,
        causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _trunk_args(rng, L=2, C=16, Hd=32, lora_r=0):
    shapes = [(L, 3 * C, C), (L, 3 * C), (L, C, C), (L, C), (L, Hd, C),
              (L, Hd), (L, C, Hd), (L, C), (L, C), (L, C), (L, C), (L, C),
              (C,), (C,)]
    if lora_r:
        shapes += [(L, lora_r, C), (L, 3 * C, lora_r)]
    return [0.3 * _rand(rng, *s) for s in shapes]


def test_attention_refuses_unported_features():
    """Sequence-parallel impls and masks or dropout on the flash impl
    still raise.  The trunk's LoRA stacks and remat are ported: LoRA
    (qkv + scale * B @ A per layer) matches the JAX op, forward and
    gradients, and every remat policy leaves output and gradients as
    they are without one."""
    q = torch.zeros((1, 1, 4, 8))
    for kwargs in ({"impl": "ring"}, {"impl": "ulysses"},
                   {"impl": "flash", "dropout_p": 0.1},
                   {"impl": "flash", "mask": torch.ones((4, 4))}):
        with pytest.raises(NotImplementedError):
            tatt.scaled_dot_product_attention(q, q, q, **kwargs)
    rng = np.random.RandomState(12)
    args = _trunk_args(rng, lora_r=3)
    x = _rand(rng, 2, 8, 16)
    kw = dict(num_heads=4, causal=True, lora_scale=1.5)

    def jax_loss(x, *a):
        return (jatt.scan_transformer_encoder(
            x, *a[:14], qkv_lora_a=a[14], qkv_lora_b=a[15], **kw,
            _is_training=False) ** 2).sum()

    want, wgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(17))))(
        jnp.asarray(x), *(jnp.asarray(a) for a in args))
    tx = [torch.from_numpy(a).requires_grad_() for a in [x] + args]
    for remat in (False, True, "dots", "save_every_k:2"):
        out = tatt.scan_transformer_encoder(
            tx[0], *tx[1:15], qkv_lora_a=tx[15], qkv_lora_b=tx[16],
            remat=remat, _is_training=False, **kw)
        loss = (out ** 2).sum()
        grads = torch.autograd.grad(loss, tx)
        np.testing.assert_allclose(float(loss), float(want), rtol=RTOL)
        for g, w in zip(grads, wgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("remat", [True, "dots", "dots_no_batch",
                                   "save_every_k:2", "save_every_k:3"])
def test_trunk_remat_keeps_dropout_gradients(remat):
    """With dropout in training mode, a rematerialised trunk (per layer,
    selective, or chunked; 3 does not divide L = 4, so per layer) gives
    the output and gradients of the plain one bitwise: the recompute
    takes back the masks its forward drew."""
    from mxnet_tpu_torch import random

    rng = np.random.RandomState(13)
    args = [torch.from_numpy(a).requires_grad_()
            for a in [_rand(rng, 2, 8, 16)] + _trunk_args(rng, L=4)]
    runs = []
    for policy in (False, remat):
        out = tatt.scan_transformer_encoder(
            *args, num_heads=4, dropout=0.3, remat=policy,
            _key=random.generator(4))
        runs.append((out, torch.autograd.grad((out ** 2).sum(), args)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_dropout_draws_from_the_generator():
    """Dense attention dropout and the trunk's dropout: masks come from
    the given generator (else the generator scope's), kept values are
    scaled by 1/keep, and predict mode drops nothing."""
    from mxnet_tpu_torch import random

    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 2, 16, 8)) for _ in range(3))
    plain = tatt.scaled_dot_product_attention(q, k, v, causal=True)
    a = tatt.scaled_dot_product_attention(
        q, k, v, causal=True, dropout_p=0.5, _key=random.generator(3))
    with random.generator_scope(random.generator(3)):
        b = tatt.scaled_dot_product_attention(q, k, v, causal=True,
                                              dropout_p=0.5)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    assert torch.equal(plain, tatt.scaled_dot_product_attention(
        q, k, v, causal=True, dropout_p=0.5, _is_training=False))
    x = torch.ones((4, 1000))
    y = tnn.dropout(x, 0.25, _key=random.generator(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03


@pytest.mark.parametrize("heads", [1, 2])
def test_interleaved_selfatt_matches_jax(heads):
    """The reference's interleaved self-attention products on a (T, B, 3C)
    projection: scaled scores, then attention times values."""
    rng = np.random.RandomState(heads)
    qkv = _rand(rng, 5, 3, 3 * 8)
    att = np.abs(_rand(rng, 3 * heads, 5, 5))
    for fn, args in (("interleaved_matmul_selfatt_qk", (qkv,)),
                     ("interleaved_matmul_selfatt_valatt", (qkv, att))):
        want = np.asarray(getattr(jatt, fn)(*map(jnp.asarray, args),
                                            heads=heads))
        got = getattr(tatt, fn)(*map(torch.from_numpy, args), heads=heads)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("raw", [None, "4,1,2", "8", "x,2", ","])
def test_batch_buckets_match_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("MXTPU_SERVE_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("MXTPU_SERVE_BUCKETS", raw)
    assert tengine.batch_buckets_from_env() == \
        jengine.batch_buckets_from_env()


@pytest.mark.parametrize("window,floor", [(16, 8), (1024, 8), (100, 3),
                                          (8, 16)])
def test_prefill_buckets_match_jax(window, floor):
    assert tengine.prefill_buckets_for(window, floor) == \
        jengine.prefill_buckets_for(window, floor)


GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _ctc_cases():
    """(pred, label): the probe batch (the second sample's four labels,
    two of them repeats, need more than its three frames), a random
    batch every sample of which fits, and a batch whose first sample
    needs all four of its frames, between two that fit and one that
    cannot; the case's third entry, where there is one, is the samples'
    frame counts."""
    rng = np.random.RandomState(0)
    probe = (rng.randn(2, 3, 5).astype(np.float32),
             np.array([[1, 2, 0, 0], [1, 1, 2, 2]], np.float32))
    rng = np.random.RandomState(1)
    feasible = (rng.randn(3, 9, 6).astype(np.float32),
                np.array([[1, 2, 3], [4, 4, 0], [5, 0, 0]], np.float32))
    rng = np.random.RandomState(2)
    boundary = (rng.randn(4, 4, 5).astype(np.float32),
                np.array([[1, 1, 2, 0], [2, 3, 0, 0], [1, 1, 2, 2],
                          [3, 0, 0, 0]], np.float32))
    rng = np.random.RandomState(3)
    lengths = (rng.randn(3, 6, 5).astype(np.float32),
               np.array([[1, 2, 0], [3, 3, 0], [1, 2, 3]], np.float32),
               np.array([6, 2, 4], np.int32))
    return {"infeasible": probe, "feasible": feasible, "boundary": boundary,
            "lengths": lengths}


@pytest.mark.parametrize("case", ["infeasible", "feasible", "boundary",
                                  "lengths"])
def test_ctc_loss_and_grad_match_jax(case):
    """CTC's loss and gradient against the JAX op, an impossible alignment
    included: its loss is the -1e30 floor's 1e30, not inf, and its
    gradient is finite and the JAX op's."""
    from mxnet_tpu.ops import ctc as jctc
    from mxnet_tpu_torch.ops import ctc as tctc

    pred, label, *frames = _ctc_cases()[case]
    jlen = [jnp.asarray(f) for f in frames]

    def loss(p):
        per_sample = jctc.ctc_loss(p, jnp.asarray(label), *jlen)
        return per_sample.sum(), per_sample

    # the loss and its gradient as one compiled program
    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(pred))
    want, want_g = np.asarray(want), np.asarray(want_g)
    p = torch.from_numpy(pred).requires_grad_()
    got = tctc.ctc_loss(p, torch.from_numpy(label),
                        *[torch.from_numpy(f) for f in frames])
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    assert np.isfinite(p.grad.numpy()).all()
    np.testing.assert_allclose(p.grad.numpy(), want_g, **GRAD_TOL)
    bad = {"infeasible": 1, "boundary": 2, "lengths": 1}.get(case)
    assert np.isfinite(got.detach().numpy()).all()
    if bad is not None:
        assert got[bad].item() == pytest.approx(1e30, rel=1e-6)
        assert (np.delete(got.detach().numpy(), bad) < 1e3).all()
