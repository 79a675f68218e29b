"""The port's flash attention (plain PyTorch versions, which a CPU tensor
takes, behind the autograd Function) against the JAX package's Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU.  Same numpy inputs through both; outputs at rtol 2e-4 / atol 2e-5 and
gradients at rtol 2e-3 / atol 2e-4, as tests/test_parallel.py's flash
tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as jflash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tflash

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,D,block", [
    (128, 16, None),    # one default tile
    (256, 32, 64),      # 4x4 blocks: multi-block online softmax
    (192, 16, None),    # odd length: a single full-length block
])
def test_flash_matches_jax_interpret(causal, T, D, block):
    q, k, v = _qkv((2, 2, T, D), seed=T + D)
    scale = D ** -0.5
    bq = bk = block or (128 if T % 128 == 0 else T)
    want, want_lse = jflash._flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, bq,
        bk)
    before = tflash.flash_attention_fwd.launches
    got, got_lse = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=block, block_k=block, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=RTOL, atol=ATOL)
    # the public entry reaches the same numbers as the JAX flash op
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jflash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=block, block_k=block)), rtol=RTOL, atol=ATOL)
    # a CPU tensor takes the plain version, never the kernel
    assert tflash.flash_attention_fwd.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [8, 48])
def test_flash_takes_any_head_dim_on_the_host(D, causal):
    """The plain version, forward and backward, at head dims the kernels
    are not built for, against the JAX flash op in interpret mode, which
    takes any D off the TPU."""
    q, k, v = _qkv((2, 2, 64, D), seed=D)
    g = _qkv((2, 2, 64, D), seed=D + 1)[0]
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal), jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_flash_bf16_matches_jax_interpret():
    """bf16: q and k upcast for QK^T, P rounded to bf16 before P.V, O
    rounded to bf16.  Both sides round at the same points over the same
    tiles, so they differ by the f32 summation order only: at most one
    bf16 step of O (2^-7 relative) where that order tips a rounding."""
    q, k, v = _qkv((1, 2, 128, 32), seed=5)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jflash.flash_attention(jq, jk, jv, causal=True)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_bf16_tile_size_bound():
    """Why the card compares the kernel with the plain version at a
    wider bf16 tolerance: P is rounded to bf16 relative to the running row
    maximum, which depends on the kv tile size, so two tilings differ by
    up to 2^-8 * sum_j p_j |v_j| / l plus one bf16 step of O -- and by
    more than one bf16 step alone."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 512, 64), generator=g).bfloat16()
               for _ in range(3))
    a, _ = tflash.flash_attention_plain(q, k, v, True, block_k=32)
    b, _ = tflash.flash_attention_plain(q, k, v, True, block_k=128)
    mag, _ = tflash.flash_attention_plain(q, k, v.abs(), True)
    diff = (a.float() - b.float()).abs()
    one_step = 2 ** -7 * b.float().abs() + 1e-6
    assert bool((diff <= one_step + 2 ** -8 * mag.float()).all())
    assert not bool((diff <= one_step).all())


BWD_CASES = [
    (128, 16, None),    # one default tile
    (256, 32, 64),      # 4x4 blocks: multi-block backward
    (192, 16, None),    # odd length: a single full-length block
]


def _jax_fwd(q, k, v, causal, block, dtype=jnp.float32):
    """O and the x8-lane LSE from the JAX forward kernel."""
    T, D = q.shape[2], q.shape[3]
    bq = block or (128 if T % 128 == 0 else T)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    o, lse = jflash._flash_call(jq, jk, jv, causal, D ** -0.5, bq, bq)
    return (jq, jk, jv), o, lse, bq


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,D,block", BWD_CASES)
def test_flash_bwd_plain_matches_jax_interpret(causal, T, D, block):
    """The plain version of the backward kernels against _flash_bwd_call
    (_dq_kernel and _dkv_kernel) on the same q, k, v, O, L and dO: the
    JAX forward's O and its x8-lane L, lane 0 for the port."""
    q, k, v, g = _qkv((2, 2, T, D), seed=T + D + 1) + \
        _qkv((2, 2, T, D), seed=T + D + 2)[:1]
    (jq, jk, jv), o, lse, bq = _jax_fwd(q, k, v, causal, block)
    want = jflash._flash_bwd_call(jq, jk, jv, o, lse, jnp.asarray(g), causal,
                                  D ** -0.5, bq, bq)
    got = tflash.flash_attention_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()),
        torch.from_numpy(g), causal, block_q=block, block_k=block)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_flash_bwd_plain_bf16_matches_jax_interpret():
    """bf16: both sides round dS to q's/k's dtype and P to dO's before
    their products and store bf16 gradients; the f32 sums differ in order
    only, so a stored gradient may differ by one bf16 step (2^-7
    relative) where that order tips a rounding."""
    q, k, v, g = _qkv((1, 2, 128, 32), seed=11) + _qkv((1, 2, 128, 32),
                                                       seed=12)[:1]
    (jq, jk, jv), o, lse, bq = _jax_fwd(q, k, v, True, None, jnp.bfloat16)
    want = jflash._flash_bwd_call(jq, jk, jv, o, lse,
                                  jnp.asarray(g, jnp.bfloat16), True,
                                  32 ** -0.5, bq, bq)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16()
    got = tflash.flash_attention_bwd_plain(
        tq, tk, tv, to, torch.from_numpy(np.asarray(lse)[..., 0].copy()), tg,
        True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,D,block", BWD_CASES[1:])
def test_flash_grad_matches_jax_grad(causal, T, D, block):
    """torch.autograd.grad through the port's flash_attention (the
    Function's plain backward on the CPU) against jax.grad of the JAX
    flash_attention, as tests/test_parallel.py's test_flash_attention_grad;
    the output's grad_fn is the port's Function."""
    q, k, v = _qkv((2, 2, T, D), seed=T + D + 3)

    def jloss(q, k, v):
        return jnp.sum(jflash.flash_attention(
            q, k, v, causal=causal, block_q=block, block_k=block) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=block,
                                 block_k=block)
    assert isinstance(out.grad_fn, tflash.FlashAttention._backward_cls)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_flash_function_on_the_cpu():
    """Every call goes through the Function: the LSE it returns is not
    differentiable, a CPU backward launches no kernel, and gradients
    arrive in the inputs' shapes and dtype, also from transposed views."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 32, 3, 2, 16), generator=g, requires_grad=True)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    out, lse = tflash.flash_attention(q, k, v, causal=True, return_lse=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert not lse.requires_grad
    before = (tflash.flash_attention_dq.launches,
              tflash.flash_attention_dkv.launches)
    (gx,) = torch.autograd.grad(out.sum(), x)
    assert gx.shape == x.shape and gx.dtype == x.dtype
    assert (tflash.flash_attention_dq.launches,
            tflash.flash_attention_dkv.launches) == before
    bq, bk, bv = (b.bfloat16() for b in (q, k, v))
    ob = tflash.flash_attention(bq.detach().requires_grad_(), bk, bv)
    assert ob.dtype == torch.bfloat16
    with torch.inference_mode():
        assert tflash.flash_attention(q, k, v).grad_fn is None


def test_flash_bwd_wrappers_need_cuda_tensors():
    q = torch.zeros((1, 1, 64, 16))
    lse = torch.zeros((1, 64))
    with pytest.raises(MXNetError, match="needs CUDA"):
        tflash.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(MXNetError, match="needs CUDA"):
        tflash.flash_attention_dq(q, q, q, q, lse, q)
    with pytest.raises(MXNetError, match="needs CUDA"):
        tflash.flash_attention_dkv(q, q, q, lse, q, lse)
    with pytest.raises(ValueError, match="LSE and D must be"):
        tflash.flash_attention_bwd_plain(q, q, q, q, lse.T, q)


def test_flash_rejects_non_dividing_blocks():
    q = torch.zeros((1, 1, 128, 16))
    with pytest.raises(ValueError, match="must divide"):
        tflash.flash_attention(q, q, q, block_q=96)


@pytest.mark.parametrize("shapes,dtype,match", [
    (((1, 1, 64, 16), (1, 1, 32, 16)), torch.float32, "Tq == Tk"),
    (((1, 1, 64, 24), (1, 1, 64, 24)), torch.float32, "head dim"),
    (((1, 1, 64, 16), (1, 1, 64, 16)), torch.float16, "float32 or bfloat16"),
])
def test_flash_rejects_what_the_kernel_does_not_take(shapes, dtype, match):
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    if match == "head dim":
        # the plain version takes any D, as the JAX op off the TPU; only a
        # kernel launch refuses a D it was not built for
        assert tflash.flash_attention(q, k, k).shape == q.shape
        with pytest.raises(MXNetError, match="head dim 24 has no kernel"):
            tflash.flash_attention_fwd(q, k, k)
        return
    with pytest.raises(ValueError, match=match):
        tflash.flash_attention(q, k, k)


def test_flash_refuses_a_device_without_kernel():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    q = torch.zeros((1, 1, 64, 16), device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(MXNetError, match="needs CUDA"):
        tflash.flash_attention_fwd(torch.zeros((1, 1, 64, 16)),
                                   torch.zeros((1, 1, 64, 16)),
                                   torch.zeros((1, 1, 64, 16)))


# -- the error budget of 3xTF32 --------------------------------------------
# The CUDA kernels run f32 products on the tensor cores as 3xTF32: each
# operand x is split into big = rna_tf32(x) and small = rna_tf32(x - big)
# and a product is small*big + big*small + big*big.  Emulated here (TF32
# rounding on the int32 view, products summed in f64) for the forward's
# Q.K^T and P.V and for the dQ kernel's Q.K^T, dO.V^T and dS.K, so the
# design's error budget is pinned where the CPU tests run: the split holds
# the f32 tolerances against the JAX package's kernels, one TF32 product
# per f32 product does not.


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, products):
    """a @ b from TF32 operands: ``products`` 1 (big*big) or 3 (3xTF32)."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab.double() @ bb.double()
    if products == 3:
        out = out + (_tf32(a - ab).double() @ bb.double()
                     + ab.double() @ _tf32(b - bb).double())
    return out


def _tf32_attention(q, k, v, causal, products):
    T, D = q.shape[-2:]
    s = _tf32_matmul(q, k.transpose(-1, -2), products) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _tf32_matmul(p.float(), v, products) / l
    return o.float(), (m + torch.log(l)).float().reshape(-1, T)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("products", [1, 3])
def test_3xtf32_holds_the_f32_tolerance(causal, products):
    q, k, v = _qkv((1, 2, 512, 64), seed=512)
    want, want_lse = jflash._flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64 ** -0.5,
        128, 128)
    want, want_lse = np.asarray(want), np.asarray(want_lse)[..., 0]
    got, got_lse = _tf32_attention(*map(torch.from_numpy, (q, k, v)), causal,
                                   products)
    close = (np.allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
             and np.allclose(got_lse.numpy(), want_lse, rtol=RTOL, atol=ATOL))
    assert close == (products == 3)


def _tf32_dq(q, k, v, o, lse, do, causal, products):
    """The dQ kernel's arithmetic with its three products (Q.K^T, dO.V^T,
    dS.K) from TF32 operands, everything else in f32: S, P, D and dS as
    the kernel forms them, on the given O and L."""
    T, D = q.shape[-2:]
    scale = D ** -0.5
    s = _tf32_matmul(q, k.transpose(-1, -2), products).float() * scale
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - lse.reshape(*q.shape[:2], T, 1))
    p = p.masked_fill(s <= -5e29, 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    dp = _tf32_matmul(do, v.transpose(-1, -2), products).float()
    ds = p * (dp - delta) * scale
    return _tf32_matmul(ds, k, products).float()


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_holds_the_gradient_tolerance_for_dq(causal):
    """dQ from 3xTF32 products against _dq_kernel in interpret mode
    (_flash_bwd_call) on the JAX forward's O and L, at the size of the
    forward's case above: the split holds the gradient tolerance (worst
    err/tol 8.2e-4 without the causal mask, 3.1e-3 with it).  One TF32
    product per f32 product does not hold it at this size: err/tol 1.08
    without the mask, 5.46 with it."""
    q, k, v = _qkv((1, 2, 512, 64), seed=512)
    g = _qkv((1, 2, 512, 64), seed=513)[0]
    (jq, jk, jv), o, lse, bq = _jax_fwd(q, k, v, causal, None)
    want = np.asarray(jflash._flash_bwd_call(
        jq, jk, jv, o, lse, jnp.asarray(g), causal, 64 ** -0.5, bq, bq)[0])
    args = [torch.from_numpy(x) for x in (q, k, v)] + [
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()), torch.from_numpy(g)]
    ratio = {}
    for products in (1, 3):
        got = _tf32_dq(*args, causal, products).numpy()
        ratio[products] = float(
            (np.abs(got - want) / (GRAD_ATOL + GRAD_RTOL * np.abs(want)))
            .max())
    assert ratio[3] <= 1.0, ratio
    assert ratio[3] < ratio[1] / 100, ratio
