"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``gpu``: each test decides inside itself whether a card
is present and skips otherwise.  Imports torch and the port only, so it
runs on a host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tflash

pytestmark = pytest.mark.gpu

# f32: rtol 2e-4 / atol 2e-5 as the JAX flash tests.  bf16: each version
# rounds P to bf16 relative to its running row maximum, and the kernel's
# 32-key tiles reach other maxima than the plain version's tiles, so O
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
