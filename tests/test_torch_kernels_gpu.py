"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``gpu``: each test decides inside itself whether a card
is present and skips otherwise.  Imports torch and the port only, so it
runs on a host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tflash
from torch_one_thread import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

# f32: rtol 2e-4 / atol 2e-5 as the JAX flash tests.  bf16: each version
# rounds P to bf16 relative to its running row maximum, and the kernel's
# 64-key tiles reach other maxima than the plain version's tiles, so O
# may differ by 2^-8 * sum_j p_j |v_j| / l (the plain version on |v|)
# plus one bf16 step of O (2^-7 relative); chip_smoke.py states the same.
TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2 ** -7, 1e-6)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,T,D", [
    (2, 3, 256, 64),
    (1, 2, 1000, 64),     # ragged tail: T not a multiple of the tiles
    (1, 2, 77, 16),
    (1, 2, 130, 32),
    (2, 2, 200, 128),     # two threads per row
])
def test_flash_kernel_matches_plain(B, H, T, D, causal, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + D)
    q, k, v = (torch.randn((B, H, T, D), device=dev, generator=g)
               .to(dtype) for _ in range(3))
    want, want_lse = tflash.flash_attention_plain(q, k, v, causal)
    before = tflash.flash_attention_fwd.launches
    got, got_lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    rtol, atol = TOL[dtype]
    if dtype == torch.bfloat16:
        mag, _ = tflash.flash_attention_plain(q, k, v.abs(), causal)
        atol = atol + 2 ** -8 * mag.float()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), \
        float(diff.max())
    torch.testing.assert_close(got_lse, want_lse, rtol=2e-4, atol=2e-5)


def _assert_fwd_close(got, got_lse, want, want_lse, q, k, v, causal):
    rtol, atol = TOL[q.dtype]
    if q.dtype == torch.bfloat16:
        mag, _ = tflash.flash_attention_plain(q, k, v.abs(), causal)
        atol = atol + 2 ** -8 * mag.float()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), \
        float(diff.max())
    torch.testing.assert_close(got_lse, want_lse, rtol=2e-4, atol=2e-5)


# The edges of the kernels' tiles: the forward's 128-row q tiles and 64-row
# kv tiles, the dQ kernel's 64-row q tiles and 64-row kv tiles (32 at
# D = 128), the dK/dV kernel's 64-row kv tiles and 64-row q tiles (32 at
# D = 128), one row either side of each, and T = 1.
TILE_EDGES = (1, 15, 63, 64, 65, 127, 129)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", TILE_EDGES)
def test_flash_kernel_at_tile_edges(T, D, causal, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7 * T + D)
    q, k, v = (torch.randn((1, 2, T, D), device=dev, generator=g)
               .to(dtype) for _ in range(3))
    got, got_lse = tflash.flash_attention_fwd(q, k, v, causal)
    want, want_lse = tflash.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_fwd_close(got, got_lse, want, want_lse, q, k, v, causal)


def test_flash_f32_at_scale_30_needs_3xtf32():
    """At inputs x30 the scores reach ~1e3, and one TF32 product per f32
    product (the plain version with TF32 matmuls) misses the f32 LSE
    tolerance, where the kernel's 3xTF32 holds it.  O is ill-conditioned
    there (an f32 rounding of s moves p by ~1e-3 relative, so even the
    exact answer misses rtol 2e-4 against the plain version): the kernel's
    O must be as close to an f64 reference as the plain f32 version's."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(30)
    q, k, v = (30 * torch.randn((1, 2, 512, 64), device=dev, generator=g)
               for _ in range(3))
    got, got_lse = tflash.flash_attention_fwd(q, k, v, True)
    want, want_lse = tflash.flash_attention_plain(q, k, v, True)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) / 8.0
    s = s.masked_fill(torch.ones((512, 512), dtype=torch.bool,
                                 device=dev).triu(1), float("-inf"))
    exact = torch.matmul(torch.softmax(s, -1), v.double())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, tf32_lse = tflash.flash_attention_plain(q, k, v, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.testing.assert_close(got_lse, want_lse, rtol=2e-4, atol=2e-5)
    assert not torch.allclose(tf32_lse, want_lse, rtol=2e-4, atol=2e-5)
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((want.double() - exact).abs().max())
    assert err_kernel <= 4 * err_plain + 2e-5, (err_kernel, err_plain)


def test_flash_kernels_take_unaligned_tensors():
    """The kernels copy 16-byte chunks: flash_attention copies a tensor
    that starts off a 16-byte boundary, and the raw dK/dV entry refuses
    one."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    flat = [torch.randn(2 * 3 * 130 * 32 + 1, device=dev, generator=g)
            for _ in range(4)]
    q, k, v, do = (x[1:].view(2, 3, 130, 32) for x in flat)
    assert q.is_contiguous() and q.data_ptr() % 16
    got = tflash.flash_attention(q, k, v, causal=True)
    want, _ = tflash.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    o, lse = tflash.flash_attention_fwd(q, k, v, True)
    dq, delta = tflash.flash_attention_dq(*(x.clone() for x in (q, k, v, o)),
                                          lse, do.clone(), True)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention_dkv(q, k, v, lse, do, delta, True)


def test_flash_kernel_takes_transposed_views():
    """The trunk's head split hands the kernel non-contiguous views."""
    dev = _card()
    x = torch.randn((2, 128, 3, 2, 64), device=dev)     # (B, T, 3, H, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    got = tflash.flash_attention(q, k, v, causal=True)
    want, _ = tflash.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def _bwd_case(B, H, T, D, causal, dtype, seed):
    """q, k, v, dO from a seed; O and LSE from the forward kernel."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, H, T, D), device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    o, lse = tflash.flash_attention_fwd(q, k, v, causal)
    return q, k, v, o, lse, do


def _bwd_magnitudes(q, k, v, o, lse, do, causal):
    """Dense f32 sums of |term| behind dQ, dK and dV, with |dS| bounded
    by P * (|dO| |V|^T + |D|) * scale."""
    B, H, T, D = q.shape
    scale = D ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
    p = torch.exp(s - lse.reshape(B, H, T, 1)).masked_fill(s <= -5e29, 0.0)
    delta = (gf * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf.abs(), vf.abs().transpose(-1, -2))
              + delta.abs()) * scale
    return (torch.matmul(ds, kf.abs()),
            torch.matmul(p.transpose(-1, -2), gf.abs()),
            torch.matmul(ds.transpose(-1, -2), qf.abs()))


# Backward, kernel against plain version.  f32: rtol 2e-3 / atol 2e-4, the
# JAX package's gradient tolerance (tests/test_parallel.py:346-348).  bf16:
# both versions round P and dS to bf16 before their products, from f32
# values that differ in summation order, so a rounding may tip: each term
# of a sum may differ by one bf16 step (2^-7 relative), bounded by 2^-7
# times the sum of |term| (``_bwd_magnitudes``), plus one bf16 step of the
# stored result.  chip_smoke.py states the same.
BWD_TOL = {torch.float32: (2e-3, 2e-4), torch.bfloat16: (2 ** -7, 1e-6)}


def _assert_bwd_close(got, want, mags, dtype):
    rtol, atol = BWD_TOL[dtype]
    for name, a, b, m in zip(("dq", "dk", "dv"), got, want, mags):
        assert a.dtype == dtype and a.shape == b.shape, name
        tol = atol + rtol * b.float().abs()
        if dtype == torch.bfloat16:
            tol = tol + 2 ** -7 * m
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= tol).all()), (name, float(diff.max()))
        assert bool(torch.isfinite(a.float()).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,T,D", [
    (2, 3, 256, 64),
    (1, 2, 1000, 64),     # ragged tail: T not a multiple of the tiles
    (1, 2, 77, 16),
    (1, 2, 130, 32),
    (2, 2, 200, 128),     # four threads per row
])
def test_flash_bwd_kernels_match_plain(B, H, T, D, causal, dtype):
    q, k, v, o, lse, do = _bwd_case(B, H, T, D, causal, dtype, T + D)
    n_dq = tflash.flash_attention_dq.launches
    n_dkv = tflash.flash_attention_dkv.launches
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention_dq.launches == n_dq + 1
    assert tflash.flash_attention_dkv.launches == n_dkv + 1
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    _assert_bwd_close(got, want, _bwd_magnitudes(q, k, v, o, lse, do, causal),
                      dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", TILE_EDGES)
def test_flash_bwd_kernels_at_tile_edges(T, D, causal, dtype):
    q, k, v, o, lse, do = _bwd_case(1, 2, T, D, causal, dtype, 7 * T + D)
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    _assert_bwd_close(got, want, _bwd_magnitudes(q, k, v, o, lse, do, causal),
                      dtype)


def test_flash_bwd_f32_at_scale_30_needs_3xtf32():
    """The backward at inputs x30, as the forward's case above: the scores
    reach ~1e3 and dQ is ill-conditioned (an f32 rounding of s moves p by
    ~1e-4 relative), so the dQ kernel is held to an f64 reference (softmax,
    O and D in f64) beside the plain f32 backward, by relative L2 error.
    3xTF32 keeps 22 of f32's 24 significand bits, so its error may be 4x
    the plain version's, and 2x more for the f32 sums taken in another
    order; one TF32 product per f32 product (the plain backward with TF32
    matmuls) misses that bound.  D, a sum of 64 products of ~900, may
    differ from the plain version's by the order of the sum: it is held
    to the backward's f32 tolerance."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(30)
    q, k, v, do = (30 * torch.randn((1, 2, 512, 64), device=dev,
                                    generator=g) for _ in range(4))
    o, lse = tflash.flash_attention_plain(q, k, v, True)
    got, delta = tflash.flash_attention_dq(q, k, v, o, lse, do, True)
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, True)[0]
    qd, kd, vd, gd = (x.double() for x in (q, k, v, do))
    s = torch.matmul(qd, kd.transpose(-1, -2)) / 8.0
    s = s.masked_fill(torch.ones((512, 512), dtype=torch.bool,
                                 device=dev).triu(1), float("-inf"))
    p = torch.softmax(s, -1)
    d_exact = (gd * torch.matmul(p, vd)).sum(-1, keepdim=True)
    exact = torch.matmul(
        p * (torch.matmul(gd, vd.transpose(-1, -2)) - d_exact) / 8.0, kd)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, True)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()

    def rel(x):
        return float((x.double() - exact).norm() / exact.norm())

    rtol, atol = BWD_TOL[torch.float32]
    torch.testing.assert_close(delta, (do * o).sum(-1).reshape(2, 512),
                               rtol=rtol, atol=atol)
    assert rel(got) <= 8 * rel(want), (rel(got), rel(want))
    assert rel(tf32) > 8 * rel(want), (rel(tf32), rel(want))


def test_flash_grads_through_function_on_cuda():
    """Gradients through the autograd Function on CUDA: transposed head
    views in, a strided dO, every gradient present, one launch of each
    kernel per backward, and the plain version's numbers."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 256, 3, 4, 64), device=dev, generator=g,
                    requires_grad=True)                    # (B, T, 3, H, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    before = (tflash.flash_attention_fwd.launches,
              tflash.flash_attention_dq.launches,
              tflash.flash_attention_dkv.launches)
    out = tflash.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    do = torch.randn((2, 4, 64, 256), device=dev,
                     generator=g).transpose(-1, -2)        # strided dO
    (gx,) = torch.autograd.grad(out, x, do)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_fwd.launches,
            tflash.flash_attention_dq.launches,
            tflash.flash_attention_dkv.launches) == tuple(
                n + 1 for n in before)
    assert gx is not None and bool(torch.isfinite(gx).all())
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = tflash.flash_attention_plain(qd, kd, vd, True)
    want = tflash.flash_attention_bwd_plain(qd, kd, vd, o, lse,
                                            do.contiguous(), True)
    got = tuple(gx[:, :, i].transpose(1, 2) for i in range(3))
    _assert_bwd_close(got, want, (0, 0, 0), torch.float32)


def test_flash_kernel_refuses_mixed_devices():
    dev = _card()
    q = torch.zeros((1, 1, 64, 16), device=dev)
    with pytest.raises((ValueError, MXNetError)):
        tflash.flash_attention(q, q.cpu(), q)


@pytest.mark.parametrize("D", [8, 48])
def test_flash_kernels_refuse_a_head_dim_they_lack(D):
    """The plain version takes any D (the CPU tests hold it against the
    JAX op); on the card a D outside HEAD_DIMS raises, never falling back
    to the plain version."""
    dev = _card()
    q = torch.randn((1, 2, 64, D), device=dev, requires_grad=True)
    with pytest.raises(MXNetError, match=f"head dim {D} has no kernel"):
        tflash.flash_attention(q, q, q)
    lse = torch.zeros((2, 64), device=dev)
    x = q.detach()
    with pytest.raises(MXNetError, match="has no kernel"):
        tflash.flash_attention_dq(x, x, x, x, lse, x)
    with pytest.raises(MXNetError, match="has no kernel"):
        tflash.flash_attention_dkv(x, x, x, lse, x, lse)


# -- runtime-compiled kernels: mxnet_tpu_torch.rtc.CudaModule ----------------
# The sources are hand-written CUDA C++ strings; chip_smoke.py holds the
# same two.  scale2 is the counterpart of the JAX package's PallasModule
# test kernel (tests/test_aux.py:256-272), axpy MXNet's rtc example.  Both
# are one f32 multiply (and add) an element: scale2 equals 2 * x exactly,
# and axpy may fuse y + alpha*x into one FMA where torch rounds alpha*x
# and then the sum, so |diff| <= 2^-24 (|ax| + 2|y + ax|) <= 2^-22
# (|y| + |alpha x|); chip_smoke.py states the same.

SCALE2_SRC = r"""
extern "C" __global__ void scale2(const float *__restrict__ x,
                                  float *__restrict__ y, long long n)
{
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride)
        y[i] = 2.0f * x[i];
}
"""

AXPY_SRC = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha, int n)
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += alpha * x[i];
}
"""

TEMPLATE_SRC = r"""
template <typename T>
__global__ void scale_t(const T *x, T *y, T a, int n)
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = a * x[i];
}
"""


def _rtc_kernels():
    from mxnet_tpu_torch import rtc

    s2 = rtc.CudaModule(SCALE2_SRC).get_kernel(
        "scale2", "const float *x, float *y, int64_t n")
    ax = rtc.CudaModule(AXPY_SRC).get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    return s2, ax


def _grid(n, block=256):
    return (max(1, min((n + block - 1) // block, 132 * 16)), 1, 1)


@pytest.mark.parametrize("n", [1, 255, 1000003, 1 << 22])
def test_rtc_scale2_and_axpy_match_plain(n):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    dev = _card()
    s2, ax = _rtc_kernels()
    g = torch.Generator(device=dev).manual_seed(n)
    x = nd.NDArray(torch.randn(n, device=dev, generator=g))
    y = nd.NDArray(torch.randn(n, device=dev, generator=g))
    y0 = y._data.clone()
    before = (s2.launches, ax.launches)
    out = nd.zeros((n,))
    assert s2.launch([x, out, n], mx.gpu(0), _grid(n), (256, 1, 1)) is None
    ax.launch([x, y, -0.25, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
              (256, 1, 1))
    torch.cuda.synchronize()
    assert (s2.launches, ax.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out._data, 2 * x._data)
    want = y0 + -0.25 * x._data
    tol = 2 ** -22 * (y0.abs() + 0.25 * x._data.abs())
    assert bool(((y._data - want).abs() <= tol).all())


def test_rtc_templated_kernel_through_exports():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, rtc

    dev = _card()
    mod = rtc.CudaModule(TEMPLATE_SRC,
                         exports=["scale_t<float>", "scale_t<double>"])
    assert set(mod.lowered) == {"scale_t<float>", "scale_t<double>"}
    for ctype, dt in (("float", torch.float32), ("double", torch.float64)):
        k = mod.get_kernel(f"scale_t<{ctype}>",
                           f"const {ctype} *x, {ctype} *y, {ctype} a, int n")
        x = nd.NDArray(torch.arange(1000, dtype=dt, device=dev))
        y = nd.NDArray(torch.zeros(1000, dtype=dt, device=dev))
        k.launch([x, y, 1.5, 1000], mx.gpu(0), (4, 1, 1), (256, 1, 1))
        torch.cuda.synchronize()
        assert torch.equal(y._data, 1.5 * x._data)
    with pytest.raises(MXNetError, match="no kernel"):
        mod.get_kernel("scale_t<int>", "const int *x, int *y, int a, int n")


def test_rtc_orders_with_torch_on_a_side_stream():
    """Launched on the current stream: a torch op before and after, on a
    non-default stream, with no sync between."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    _card()
    s2, _ = _rtc_kernels()
    n = 1 << 24
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = nd.ones((n,)) * 3.0                  # queued on `side`
        y = nd.zeros((n,))
        s2.launch([x, y, n], mx.gpu(0), _grid(n), (256, 1, 1))
        z = y + 1.0                              # reads the kernel's y
    side.synchronize()
    assert float(nd.min(z)) == 7.0 and float(nd.max(z)) == 7.0


def test_rtc_writes_reach_only_the_written_array():
    """Item 5's aliasing check on CUDA tensors: aliases of the written
    array (slice, detach, reshape, copy) and the const input keep their
    values; only the written array and its version move."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    _card()
    _, ax = _rtc_kernels()
    x = nd.array(np.arange(4096, dtype=np.float32))
    y = nd.ones((4096,))
    aliases = [y[0:100], y.detach(), y.reshape((64, 64)), y.copy(),
               y.as_in_context(mx.cpu()), y.astype("float32")]
    snaps = [a.asnumpy().copy() for a in aliases]
    xv, yv = x.version, y.version
    ax.launch([x, y, 2.0, 4096], mx.gpu(0), (16, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(y.asnumpy(), 1 + 2 * np.arange(4096))
    for a, s in zip(aliases, snaps):
        np.testing.assert_array_equal(a.asnumpy(), s)
    np.testing.assert_array_equal(x.asnumpy(), np.arange(4096))
    assert (x.version, y.version) == (xv, yv + 1)


def test_rtc_refuses_bad_arguments_and_sources():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, rtc

    _card()
    _, ax = _rtc_kernels()
    x, y = nd.ones((8,)), nd.zeros((8,))
    with pytest.raises(MXNetError, match="float32"):
        ax.launch([x, y.astype("float64"), 1.0, 8], mx.gpu(0), (1,), (8,))
    with pytest.raises(MXNetError, match="is on cpu"):
        ax.launch([x, y.as_in_context(mx.cpu()), 1.0, 8], mx.gpu(0), (1,),
                  (8,))
    with pytest.raises(MXNetError, match="GPU context"):
        ax.launch([x, y, 1.0, 8], mx.cpu(), (1,), (8,))
    with pytest.raises(MXNetError, match="error") as err:
        rtc.CudaModule('extern "C" __global__ void k(float *y) { y[0] = ; }')
    assert "log" in str(err.value)


def test_nd_autograd_on_the_card_matches_the_host():
    """The imperative path with no context given lands on cuda:0; its
    gradients equal the host's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    _card()
    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((256, 32)), rng.standard_normal((256, 1))
    grads = []
    for ctx in (None, mx.cpu()):
        Xn, yn = nd.array(X, ctx=ctx), nd.array(y, ctx=ctx)
        w, b = nd.zeros((32, 1), ctx=ctx), nd.zeros((1,), ctx=ctx)
        for p in (w, b):
            p.attach_grad()
        with autograd.record():
            loss = nd.mean(nd.square(nd.dot(Xn, w + 0.1) + b - yn))
        loss.backward()
        grads.append((w.grad.asnumpy(), b.grad.asnumpy(),
                      w._data.device.type))
    assert grads[0][2] == "cuda" and grads[1][2] == "cpu"
    for a, c in zip(grads[0][:2], grads[1][:2]):
        np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)


# -- the NN op family on the card (cuDNN and PyTorch's kernels): the card
# against the host on the same inputs, f32 with TF32 off, both layouts, at
# tests/test_parallel.py's tolerances (outputs 2e-4 / 2e-5, gradients
# 2e-3 / 2e-4) --------------------------------------------------------------

def _to_layout(a, layout):
    return a if layout == "NCHW" else a.permute(0, 2, 3, 1).contiguous()


def _card_and_host(fn, arrays):
    """fn's outputs and the gradients of sum(out * c) with respect to every
    input, on the card and on the host."""
    dev = _card()
    g = torch.Generator().manual_seed(len(arrays))
    res = []
    for d in (dev, torch.device("cpu")):
        xs = [a.to(d).requires_grad_(True) for a in arrays]
        out = fn(*xs)
        c = torch.randn(out.shape, generator=g).to(d)
        grads = torch.autograd.grad((out * c).sum(), xs)
        res.append([out.detach().cpu()] + [t.cpu() for t in grads])
        g.manual_seed(len(arrays))
    return res


def _close(card, host):
    torch.testing.assert_close(card[0], host[0], rtol=2e-4, atol=2e-5)
    for a, b in zip(card[1:], host[1:]):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,pad,groups", [(1, 1, 1), (2, 3, 1),
                                               (1, 0, 2)])
def test_convolution_on_the_card_matches_the_host(layout, stride, pad,
                                                  groups):
    from mxnet_tpu_torch.ops import nn as tnn

    g = torch.Generator().manual_seed(stride + pad)
    x = _to_layout(torch.randn(2, 8, 17, 17, generator=g), layout)
    w = torch.randn(16, 8 // groups, 3, 3, generator=g) * 0.2
    b = torch.randn(16, generator=g)

    def conv(x, w, b):
        return tnn.convolution(x, w, b, kernel=(3, 3), stride=stride,
                               pad=pad, num_filter=16, num_group=groups,
                               layout=layout)

    _close(*_card_and_host(conv, [x, w, b]))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type,convention", [
    ("max", "valid"), ("avg", "valid"), ("avg", "full"), ("max", "full")])
def test_pooling_on_the_card_matches_the_host(layout, pool_type,
                                              convention):
    from mxnet_tpu_torch.ops import nn as tnn

    g = torch.Generator().manual_seed(3)
    x = _to_layout(torch.randn(2, 4, 15, 15, generator=g), layout)

    def pool(x):
        return tnn.pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type=pool_type,
                           pooling_convention=convention,
                           count_include_pad=False, layout=layout)

    _close(*_card_and_host(pool, [x]))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_on_the_card_matches_the_host(layout, dtype):
    """Training mode: the output and the batch statistics, and the
    gradients of x, gamma and beta; bf16 is held at one bf16 step of the
    output's scale (2^-7 relative, the two sums round differently)."""
    from mxnet_tpu_torch.ops import nn as tnn

    dev = _card()
    g = torch.Generator().manual_seed(5)
    x = _to_layout(torch.randn(8, 16, 9, 9, generator=g) * 2 + 0.5, layout)
    gamma = torch.rand(16, generator=g) + 0.5
    beta = torch.randn(16, generator=g)
    axis = 1 if layout == "NCHW" else 3
    res = []
    for d in (dev, torch.device("cpu")):
        xs = x.to(d, dtype).requires_grad_(True)
        gs, bs = (t.to(d, dtype).requires_grad_(True) for t in (gamma, beta))
        mm, mv = torch.zeros(16, device=d, dtype=dtype), \
            torch.ones(16, device=d, dtype=dtype)
        out, mean, var = tnn.batch_norm(xs, gs, bs, mm, mv, fix_gamma=False,
                                        output_mean_var=True, axis=axis,
                                        _is_training=True)
        c = torch.linspace(-1, 1, out.numel()).reshape(out.shape).to(d)
        grads = torch.autograd.grad((out.float() * c).sum(), (xs, gs, bs))
        res.append([t.detach().float().cpu() for t in (out, mean, var)
                    + grads])
    if dtype == torch.float32:
        for i, (a, b) in enumerate(zip(*res)):
            tol = (2e-4, 2e-5) if i < 3 else (2e-3, 2e-4)
            torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1])
    else:
        for a, b in zip(*res):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 2 ** -7 * scale + 1e-6


# -- the input path: DevicePrefetcher on the card ------------------------------

def _loader_source(kind, n=96, batch=8):
    """A uint8 image and int32 label dataset through ``kind``'s loader,
    and the host's own collation of each batch."""
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (n, 16, 16, 3)).astype(np.uint8)
    lab = rng.randint(0, 1000, n).astype(np.int32)
    want = [(img[i:i + batch], lab[i:i + batch]) for i in range(0, n, batch)]
    if kind == "generator":
        # host tensors, one of them bf16 (cast on the host)
        src = [(torch.from_numpy(a), torch.from_numpy(b.astype(np.float32))
                .to(torch.bfloat16)) for a, b in want]
        want = [(a, b.float().numpy()) for a, b in src]
        return iter(src), want
    kw = {"threads": dict(num_workers=2),
          "pinned": dict(num_workers=2, pin_memory=True)}[kind]
    return DataLoader(ArrayDataset(img, lab), batch_size=batch, **kw), want


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("kind", ["threads", "pinned", "generator"])
def test_prefetched_batches_are_the_source_bitwise_when_the_ring_wraps(
        kind, depth):
    """A slow consumer (a sleep on its stream before each read) lets the
    producer wrap the pinned ring many times; each batch, copied on the
    consumer's stream after the sleep and then dropped, must still hold
    the host's bytes (the slot ring's events and record_stream keep both
    the staging and the device memory from reuse)."""
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    dev = _card()
    src, want = _loader_source(kind)
    holders = [(torch.empty(a.shape, dtype=torch.uint8, device=dev),
                torch.empty(b.shape, dtype=torch.float32, device=dev))
               for a, b in want]
    n = 0
    for i, (x, y) in enumerate(DevicePrefetcher(src, depth=depth)):
        assert x.context.device == dev
        torch.cuda._sleep(20_000_000)        # ~10 ms of a slow step
        holders[i][0].copy_(x._data)
        holders[i][1].copy_(y._data.float())
        del x, y
        n += 1
    torch.cuda.synchronize()
    assert n == len(want)
    for (hx, hy), (a, b) in zip(holders, want):
        np.testing.assert_array_equal(hx.cpu().numpy(), a)
        np.testing.assert_array_equal(hy.cpu().numpy(), b)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("workers", [0, 2])
def test_prefetcher_waits_for_samples_a_transform_writes_on_the_card(
        workers, depth):
    """A dataset held on the card, with ``vision.transforms.ToTensor``
    behind a sleep on the fetching thread's stream (a loader worker's
    transforms run on the default stream): each batch is stacked only
    after the transform has written its samples, and the samples' memory
    is not reused before the stack has read it.  Every batch is bitwise
    the same transform run on the whole array."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.data import (ArrayDataset, DataLoader,
                                            DevicePrefetcher)
    from mxnet_tpu_torch.gluon.data.vision import transforms

    dev = _card()
    ctx = context_of(dev)
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (64, 16, 16, 3)).astype(np.uint8)
    lab = rng.randint(0, 10, 64).astype(np.int32)
    to_tensor = transforms.ToTensor()
    want = to_tensor(nd.array(img, ctx=ctx, dtype="uint8")).asnumpy()

    def slow_to_tensor(x):
        torch.cuda._sleep(5_000_000)     # the stream busy ~2.5 ms first
        return to_tensor(x)

    ds = ArrayDataset(nd.array(img, ctx=ctx, dtype="uint8"), lab) \
        .transform_first(slow_to_tensor)
    loader = DataLoader(ds, batch_size=8, num_workers=workers)
    got_x, got_y = [], []
    with ctx:
        for x, y in DevicePrefetcher(loader, depth=depth):
            assert x.context.device == dev and y.context.device == dev
            got_x.append(x.asnumpy())
            got_y.append(y.asnumpy())
    np.testing.assert_array_equal(np.concatenate(got_x), want)
    np.testing.assert_array_equal(np.concatenate(got_y), lab)


def _trace_events(prof, tmp_path):
    import json

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_prefetcher_makes_one_copy_per_array_on_its_own_stream(tmp_path):
    """torch.profiler counts the host-to-device copies of an epoch through
    DevicePrefetcher(DataLoader(...)): one per array of each batch, all on
    one stream that is not the consumer's."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    dev = _card()
    loader, want = _loader_source("threads")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)     # the trace drops what runs as it starts
        for x, y in DevicePrefetcher(loader, depth=2):
            (x._data.float().sum() + y._data.sum()).item()
        torch.cuda.synchronize()
    events = _trace_events(prof, tmp_path)
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    assert len(h2d) == 2 * len(want), [e["name"] for e in h2d]
    copy_streams = {e["args"]["stream"] for e in h2d}
    step_streams = {e["args"]["stream"] for e in events
                    if e.get("cat") == "kernel"}
    assert len(copy_streams) == 1 and not copy_streams & step_streams
    assert all("Pinned" in e["name"] for e in h2d), {e["name"] for e in h2d}


def test_prefetcher_forwards_a_source_exception_on_the_card():
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    _card()

    def boom():
        yield np.zeros((4, 4), np.float32)
        raise RuntimeError("source exploded")

    it = iter(DevicePrefetcher(boom(), depth=2))
    assert next(it)._data.is_cuda
    with pytest.raises(RuntimeError, match="source exploded"):
        next(it)


def test_fenced_trace_counts_every_kernel_of_a_graph_replay():
    """tools.trace_edges.kernel_records over a CUDA graph's replay, traced
    again and again: every flash forward the graph holds each time, and
    no fence record among what it returns."""
    from mxnet_tpu_torch.tools import trace_edges

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 2, 256, 64), device=dev, generator=g)
               for _ in range(3))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tflash.flash_attention(q, k, v, False)      # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(4):
            tflash.flash_attention(q, k, v, False)
    for _ in range(8):
        names = [e.name for e in trace_edges.kernel_records(graph.replay)]
        assert sum("flash_fwd" in n for n in names) == 4, names
        assert not any(trace_edges.FENCE_NAME in n for n in names)


def _emb_run(dev, captured_on, xs, vocab=64, dim=8, steps=3):
    """A ShardedEmbedding + Dense(1) model (Adam, guard on) trained on the
    card over ``xs``; returns (losses, weights, states, dispatches)."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import embedding, gluon
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon import captured, nn
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    os.environ["MXTPU_SPARSE_CAPTURED"] = "1" if captured_on else "0"
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(embedding.ShardedEmbedding(vocab, dim),
                nn.Dense(1, in_units=dim, flatten=False))
    net.initialize(init=mx.init.Xavier(), ctx=context_of(dev),
                   generator=torch.Generator(device=dev).manual_seed(3))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    captured.reset_counters()
    losses = [trainer.train_step(
        net, lambda out: (out ** 2).sum(),
        NDArray(torch.as_tensor(x, device=dev), context_of(dev))).asnumpy()
        for x in xs[:steps]]
    torch.cuda.synchronize(dev)     # a device-side assert surfaces here
    states = [s._data.clone() for i in sorted(trainer._updaters[0].states)
              for s in trainer._updaters[0].states[i]]
    return (losses, [p.data()._data.clone() for p in trainer._params],
            states, captured.dispatch_count())


@pytest.mark.parametrize("pool", ["last_row", "row_zero"])
def test_sparse_padding_meets_a_real_row_on_the_card(monkeypatch, pool):
    """A fixed bucket of 8 pads with the last real id, which is row
    vocab-1 or row 0 here: inside the CUDA graph the padded slots write
    that row with the real slot's bits (no device-side assert, no update
    of their own), so the captured step equals the eager oracle bitwise
    and rows no batch touched keep their bytes."""
    dev = _card()
    vocab = 64
    monkeypatch.setenv("MXTPU_UNIQUE_BUCKET", "8")
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    ids = np.array([3, 17, vocab - 1]) if pool == "last_row" \
        else np.array([0])
    rng = np.random.RandomState(5)
    xs = [rng.choice(ids, size=(16, 4)).astype(np.float32) for _ in range(3)]
    init = _emb_run(dev, True, xs, steps=0)[1][0]
    cap = _emb_run(dev, True, xs)
    eag = _emb_run(dev, False, xs)
    assert cap[3] == 3 and eag[3] == 0
    for a, b in zip(cap[0], eag[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cap[1] + cap[2], eag[1] + eag[2]):
        assert torch.equal(a, b)
    untouched = torch.ones(vocab, dtype=torch.bool, device=dev)
    untouched[torch.as_tensor(ids, device=dev)] = False
    assert torch.equal(cap[1][0][untouched], init[untouched])
    assert not cap[2][0][untouched].any() and not cap[2][1][untouched].any()


# -- the serving engine's graphs and the Transformer's flash path -------------


def _tiny_gpt(dev, seed=11, max_length=64):
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    net = gpt.gpt_tiny(scan_layers=True, max_length=max_length, device=dev)
    net.initialize(initializer.Xavier(),
                   generator=torch.Generator(device=dev).manual_seed(seed))
    return net


def test_engine_replays_graphs_equal_to_the_cached_decoder():
    """On the card every program is a recorded CUDA graph: warm-up records
    |B| x (|prefill| + 1) of them, the request path records nothing more
    and runs no step body outside a replay, and the tokens each request
    gets from the replayed graphs equal CachedDecoder.decode's for that
    prompt alone; the first token's logits within rtol 2e-4 / atol
    1e-5."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    dev = _card()
    net = _tiny_gpt(dev)
    eng = serving.ServingEngine(net, batch_buckets=(1, 2, 4)).warmup()
    assert eng.program_count() == 3 * (len(eng.prefill_buckets) + 1)
    for _toks, run in eng._programs.values():
        assert isinstance(run.__self__, torch.cuda.CUDAGraph)
    traces, records = serving.trace_count(), serving.compile_count()
    d0 = serving.dispatch_count()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 128, n).tolist() for n in (5, 17, 30)]
    outs, tm = eng.serve_group(prompts, 6)
    assert tm["bucket"] == [4, 32]
    assert serving.trace_count() == traces
    assert serving.compile_count() == records
    assert serving.dispatch_count() == d0 + 6
    dec = gpt.CachedDecoder(net)
    for p, got in zip(prompts, outs):
        want, lg = dec.decode(np.asarray([p]), 6, return_logits=True)
        _agree_or_tie(want.asnumpy()[0, len(p):], lg[:, 0], got)
        np.testing.assert_allclose(_prefill_logits(eng, p)[0], lg[0, 0],
                                   rtol=2e-4, atol=1e-5)


def _prefill_logits(eng, p):
    """The engine's first-token logits for prompt ``p`` alone, from its
    (1, prefill bucket) program (built here if it was not)."""
    S = eng._pick_bucket(eng.prefill_buckets, len(p), "prompt length")
    toks = np.zeros((1, S), np.int64)
    toks[0, :len(p)] = p
    zero = torch.zeros(1, dtype=torch.int64, device=eng._device)
    eng._program(1, S)
    with torch.no_grad():
        out = eng._call(1, S, zero, torch.as_tensor(toks), zero + len(p) - 1)
    return out.cpu().numpy().copy()


def _agree_or_tie(want, want_logits, got):
    """Greedy tokens equal, or first part at a step where the reference's
    top-2 margin is inside 1e-3 max|logit| (another reduction order may
    flip such a tie)."""
    diff = np.flatnonzero(np.asarray(want) != np.asarray(got))
    if diff.size:
        j = int(diff[0])
        top2 = np.sort(want_logits[j])[-2:]
        assert top2[1] - top2[0] < 1e-3 * np.abs(want_logits[j]).max(), \
            f"tokens part at step {j} with a decisive margin"


def test_engine_graphs_share_one_pool_and_reload_in_place():
    """Every graph of an engine records into one memory pool, and a
    reload copies the new weights into the tensors the graphs read: the
    next group serves the new model's tokens with no new recording."""
    from mxnet_tpu_torch import serving

    dev = _card()
    a, b = _tiny_gpt(dev, seed=1), _tiny_gpt(dev, seed=2)
    eng = serving.ServingEngine(a, batch_buckets=(1, 2)).warmup()
    pools = {run.__self__.pool() for _t, run in eng._programs.values()}
    assert pools == {eng._pool}
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    before = _prefill_logits(eng, prompts[0])
    records = serving.compile_count()
    eng.reload_from_model(b)
    assert eng.generation == 1
    after, tm = eng.serve_group(prompts, 5)
    assert tm["generation"] == 1 and serving.compile_count() == records
    eng_b = serving.ServingEngine(b, batch_buckets=(1, 2))
    want, _ = eng_b.serve_group(prompts, 5)
    for x, y in zip(after, want):
        np.testing.assert_array_equal(x, y)
    new = _prefill_logits(eng, prompts[0])
    np.testing.assert_array_equal(new, _prefill_logits(eng_b, prompts[0]))
    assert np.abs(new - before).max() > 1e-3


def test_transformer_flash_decoder_at_tiny_lengths_matches_dense():
    """The decoder's causal flash self-attention at T = 1 .. 5 (greedy
    decoding grows the target a token a step) against the dense path, on
    the same weights, forward logits at rtol 2e-4 / atol 2e-5."""
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tfm

    dev = _card()
    nets = []
    for impl in ("flash", "dense"):
        net = tfm.transformer_tiny(20, 20, dropout=0.0, max_length=16,
                                   attention_impl=impl, device=dev)
        net.initialize(initializer.Xavier(),
                       generator=torch.Generator(device=dev).manual_seed(4))
        nets.append(net)
    rng = np.random.RandomState(3)
    src = torch.as_tensor(rng.randint(3, 20, (2, 7)), device=dev)
    for T in range(1, 6):
        tgt = torch.as_tensor(rng.randint(3, 20, (2, T)), device=dev)
        before = tflash.flash_attention_fwd.launches
        with autograd.predict_mode(), torch.no_grad():
            got, want = nets[0](src, tgt), nets[1](src, tgt)
        torch.cuda.synchronize()
        assert tflash.flash_attention_fwd.launches == before + 4   # 2 + 2
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_rnn_op_card_matches_host_with_sequence_lengths():
    """The fused RNN op (LSTM, 2 layers, bidirectional, ragged sequence
    lengths) on the card against the same code on the host: outputs,
    final states and the gradients with respect to data, parameters and
    states, f32 with TF32 off, at rtol 2e-4 / atol 2e-5 (outputs) and
    2e-3 / 2e-4 (gradients)."""
    from mxnet_tpu_torch.ops import rnn as trnn

    dev = _card()
    T, B, I, H, L = 9, 3, 5, 7, 2
    rs = np.random.RandomState(0)
    n = trnn.rnn_param_size("lstm", I, H, L, bidirectional=True)
    host = [torch.from_numpy(a) for a in (
        rs.randn(T, B, I).astype(np.float32),
        (rs.randn(n) * 0.3).astype(np.float32),
        (rs.randn(2 * L, B, H) * 0.5).astype(np.float32),
        (rs.randn(2 * L, B, H) * 0.5).astype(np.float32))]
    lens = torch.tensor([9, 4, 1], dtype=torch.int32)
    cots = [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in ((T, B, 2 * H), (2 * L, B, H), (2 * L, B, H))]

    def run(device):
        args = [a.to(device).requires_grad_() for a in host]
        outs = trnn.rnn(*args, state_size=H, num_layers=L, mode="lstm",
                        bidirectional=True, state_outputs=True,
                        use_sequence_length=True,
                        sequence_length=lens.to(device), _is_training=False)
        sum((o * c.to(device)).sum() for o, c in zip(outs, cots)).backward()
        return ([o.detach().cpu() for o in outs],
                [a.grad.cpu() for a in args])

    got, want = run(dev), run("cpu")
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)
    assert not got[0][0][4:, 1, :H].any()
