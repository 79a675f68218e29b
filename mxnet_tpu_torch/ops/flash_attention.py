"""Flash attention, forward and backward: hand-written Hopper kernels,
their plain PyTorch versions, and the autograd Function around them.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``: the forward
(``_fwd_kernel`` / ``_flash_call``), the backward (``_dq_kernel`` and
``_dkv_kernel`` in ``_flash_bwd_call``) and the ``custom_vjp``
``_flash_core`` that joins them.  The kernels are
``csrc/flash_attention_fwd.cu`` (the forward) and
``csrc/flash_attention_bwd.cu`` (the dQ and dK/dV kernels), all three on
the tensor cores through the tile layer ``csrc/flash_tile.cuh``; their
source notes give the designs and the bounds.

``flash_attention`` takes (B, H, T, D) tensors and always goes through
``FlashAttention``, the ``torch.autograd.Function``, on every device.  On a
CPU tensor the Function runs the plain versions (``flash_attention_plain``
forward, ``flash_attention_bwd_plain`` backward), blockwise loops that
repeat the kernels' arithmetic at the requested ``block_q``/``block_k``
tiles.  On a CUDA tensor it launches the kernels through
``flash_attention_fwd`` and ``flash_attention_bwd`` or raises; there is
no fallback and no dense path for ragged lengths (the kernels mask a
ragged tail themselves).  The kernels pick their own tiles, so
``block_q``/``block_k`` only tile the plain versions; they are checked on
every device so a bad value fails the same way everywhere.  The plain
versions take any head dim D, as the JAX op does off the TPU; the kernels
are instantiated for D in ``HEAD_DIMS``, and a launch at another D raises
``MXNetError`` (no fallback to the plain version).

TPU artifacts left behind: the 128-lane replication of m, l and D, the x8
LSE padding (LSE is (B*H, T) f32 here), the 256-row VMEM cap on q tiles,
and ``vma``.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

_NEG = -1e30
_TILE = 128
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention: q, k, v must share one (B, H, T, D) shape "
            f"(Tq == Tk), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def _check_bwd(q, rows, like_q):
    """The backward's other inputs: ``rows`` (LSE, D) must be (B*H, T)
    f32, ``like_q`` (O, dO) shaped and typed as q, all on q's device."""
    B, H, T, _ = q.shape
    for t in like_q:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash_attention backward: O and dO must be "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in rows:
        if t.shape != (B * H, T) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention backward: LSE and D must be "
                             f"({B * H}, {T}) float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if any(t.device != q.device for t in (*rows, *like_q)):
        raise ValueError("flash_attention backward: inputs on different "
                         "devices")


def _block_sizes(T, block_q, block_k):
    default = _TILE if T % _TILE == 0 else T
    bq, bk = int(block_q or default), int(block_k or default)
    if T % bq or T % bk:
        raise ValueError(
            f"flash_attention: block sizes ({bq}, {bk}) must divide "
            f"sequence length {T} (a non-dividing block would silently "
            f"leave tail blocks unwritten)")
    return bq, bk


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_attention_plain(q, k, v, causal=False, scale=None, block_q=None,
                          block_k=None):
    """Plain PyTorch version of the forward kernel: the TPU kernel's
    blockwise online softmax, (block_q x block_k) tiles at a time.
    Returns ``(O, LSE)`` with O like q and LSE (B*H, T) f32."""
    _check(q, k, v)
    B, H, T, D = q.shape
    scale = _scale(q, scale)
    bq, bk = _block_sizes(T, block_q, block_k)
    qf, kf = q.float(), k.float()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, bq):
        rows = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        m = torch.full((B, H, bq, 1), _NEG, device=q.device)
        l = torch.zeros((B, H, bq, 1), device=q.device)
        acc = torch.zeros((B, H, bq, D), device=q.device)
        # causal: kv blocks past the last row of this q block add nothing
        stop = min(T, q0 + bq) if causal else T
        for k0 in range(0, stop, bk):
            s = torch.matmul(qf[:, :, q0:q0 + bq],
                             kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
            if causal:
                cols = torch.arange(k0, k0 + bk, device=q.device)[None, :]
                s = s.masked_fill(cols > rows, _NEG)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_next).masked_fill(s <= _NEG / 2, 0.0)
            alpha = torch.exp(m - m_next)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            m = m_next
            pv = torch.matmul(p.to(v.dtype).float(),
                              v[:, :, k0:k0 + bk].float())
            acc = acc * alpha + pv
        lsafe = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, q0:q0 + bq] = (acc / lsafe).to(q.dtype)
        lse[:, :, q0:q0 + bq] = (m + torch.log(lsafe))[..., 0]
    return out, lse.reshape(B * H, T)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None,
                              block_q=None, block_k=None):
    """Plain PyTorch version of both backward kernels, (block_q x block_k)
    tiles at a time with the kernels' causal skip.  ``lse`` is the
    forward's (B*H, T) f32 LSE, read as given (ring attention passes a
    global one).  Per tile pair, as the TPU kernels:

    - S = q.k^T * scale in f32 (q, k upcast), masked to -1e30;
      P = exp(S - L), zeroed where S <= -5e29;
    - D = rowsum(dO * O) in f32; dP = dO.V^T in f32;
      dS = P * (dP - D) * scale;
    - dQ += dS.K with dS rounded to K's dtype; dV += P^T.dO with P
      rounded to dO's dtype; dK += dS^T.Q with dS rounded to Q's dtype;
      all sums in f32.

    Returns ``(dQ, dK, dV)`` as (B, H, T, D) in q's, k's and v's dtypes."""
    _check(q, k, v)
    _check_bwd(q, (lse,), (o, do))
    B, H, T, D = q.shape
    scale = _scale(q, scale)
    bq, bk = _block_sizes(T, block_q, block_k)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    L = lse.reshape(B, H, T, 1)
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros((B, H, T, D), device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for q0 in range(0, T, bq):
        qs = slice(q0, q0 + bq)
        rows = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        stop = min(T, q0 + bq) if causal else T
        for k0 in range(0, stop, bk):
            ks = slice(k0, k0 + bk)
            s = torch.matmul(qf[:, :, qs], kf[:, :, ks].transpose(-1, -2)) \
                * scale
            if causal:
                cols = torch.arange(k0, k0 + bk, device=q.device)[None, :]
                s = s.masked_fill(cols > rows, _NEG)
            p = torch.exp(s - L[:, :, qs]).masked_fill(s <= _NEG / 2, 0.0)
            dp = torch.matmul(gf[:, :, qs], vf[:, :, ks].transpose(-1, -2))
            ds = p * (dp - delta[:, :, qs]) * scale
            dq[:, :, qs] += torch.matmul(ds.to(k.dtype).float(), kf[:, :, ks])
            dv[:, :, ks] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), gf[:, :, qs])
            dk[:, :, ks] += torch.matmul(
                ds.to(q.dtype).float().transpose(-1, -2), qf[:, :, qs])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels ------------------------------------------------------


def _fn(lib_name, fn_name, n_ptrs):
    from .. import _kernels

    fn = getattr(_kernels.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, fn, ptrs, q, causal, scale):
    """Call a kernel's C entry on the current stream of q's device; raise
    on a non-zero cudaError."""
    B, H, T, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), B * H, T, D,
                _DTYPE_CODE[q.dtype], int(bool(causal)), scale, stream)
    if rc != 0:
        raise MXNetError(f"{name}: launch failed, cudaError {rc} (shape "
                         f"{(B, H, T, D)}, {q.dtype})")


def _needs_cuda(name, q, *tensors):
    """What a kernel launch needs: q's head dim one the kernels are built
    for, and CUDA tensors, contiguous and 16-byte aligned."""
    if q.shape[-1] not in HEAD_DIMS:
        raise MXNetError(f"{name}: head dim {q.shape[-1]} has no kernel; "
                         f"the kernels take D in {HEAD_DIMS} (the plain "
                         f"version, which CPU tensors take, any D)")
    for t in (q, *tensors):
        if t.device.type != "cuda":
            raise MXNetError(f"{name}: needs CUDA tensors, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous tensors "
                             f"that start on a 16-byte boundary")


def _dense(x):
    """``x`` contiguous and 16-byte aligned, as the kernels' 16-byte copies
    need: a copy only where it is not (a view, or a slice at an odd
    offset)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _credit_flops(q, causal, times):
    """Credit ``times`` the forward's model FLOPs, ``4*B*H*T^2*D`` (half
    when causal), to an open ``telemetry.count_flops``: the counter cannot
    see a ctypes launch.  The backward's dQ and dK/dV kernels credit 1.0
    and 1.5 times it, 2.5 times the forward together."""
    from .. import telemetry

    B, H, T, D = q.shape
    telemetry.add_kernel_flops(
        times * 4 * B * H * T * T * D / (2 if causal else 1))


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Launch the forward kernel on (B, H, T, D) CUDA tensors; returns
    ``(O, LSE)`` as ``flash_attention_plain`` does.  ``launches`` counts
    the launches this wrapper made."""
    _check(q, k, v)
    # contiguous (B*H, T, D): the trunk's head split hands us transposed
    # views; one copy each is cheap beside the attention itself
    q, k, v = (_dense(x) for x in (q, k, v))
    _needs_cuda("flash_attention_fwd", q)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd",
            _fn("flash_attention_fwd", "flash_attention_fwd", 5),
            (q, k, v, out, lse), q, causal, _scale(q, scale))
    flash_attention_fwd.launches += 1
    _credit_flops(q, causal, 1.0)
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, o, lse, do, causal=False, scale=None):
    """Launch the dQ kernel on contiguous, 16-byte aligned (B, H, T, D)
    CUDA tensors.
    Returns ``(dQ, D)``: dQ in q's dtype and D = rowsum(dO * O) as a
    (B*H, T) f32 side output for ``flash_attention_dkv``.  ``launches``
    counts the launches this wrapper made."""
    _check(q, k, v)
    _check_bwd(q, (lse,), (o, do))
    _needs_cuda("flash_attention_dq", q, k, v, o, lse, do)
    B, H, T, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch("flash_attention_dq",
            _fn("flash_attention_bwd", "flash_attention_dq", 8),
            (q, k, v, o, lse, do, dq, delta), q, causal, _scale(q, scale))
    flash_attention_dq.launches += 1
    _credit_flops(q, causal, 1.0)
    return dq, delta


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, lse, do, delta, causal=False, scale=None):
    """Launch the dK/dV kernel on contiguous, 16-byte aligned (B, H, T, D)
    CUDA tensors,
    with ``delta`` from ``flash_attention_dq``.  Returns ``(dK, dV)`` in
    k's and v's dtypes.  ``launches`` counts the launches this wrapper
    made."""
    _check(q, k, v)
    _check_bwd(q, (lse, delta), (do,))
    _needs_cuda("flash_attention_dkv", q, k, v, lse, do, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_dkv",
            _fn("flash_attention_bwd", "flash_attention_dkv", 8),
            (q, k, v, lse, do, delta, dk, dv), q, causal, _scale(q, scale))
    flash_attention_dkv.launches += 1
    _credit_flops(q, causal, 1.5)
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """The backward on CUDA tensors: the dQ kernel, then the dK/dV kernel
    on the same stream (it reads the dQ kernel's D).  Takes and returns
    what ``flash_attention_bwd_plain`` does; ``dO`` may be any layout (it
    is made contiguous here, as are q, k, v and O)."""
    _check(q, k, v)
    _check_bwd(q, (lse,), (o, do))
    q, k, v, o, do, lse = (_dense(x) for x in (q, k, v, o, do, lse))
    dq, delta = flash_attention_dq(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, lse, do, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient, the counterpart of the JAX
    package's ``custom_vjp`` ``_flash_core``.  Forward returns ``(O, LSE)``
    and saves q, k, v, O and LSE; LSE is not differentiable (the JAX core
    returns O only).  Backward runs the kernels on CUDA and the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal, scale, block_q,
                                             block_k)
        elif q.device.type == "cuda":
            q, k, v = (_dense(x) for x in (q, k, v))
            out, lse = flash_attention_fwd(q, k, v, causal, scale)
        else:
            raise MXNetError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q, block_k)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q, block_k = ctx.args
        if q.device.type == "cpu":
            grads = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                              scale, block_q, block_k)
        else:
            grads = flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                        scale)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, return_lse=False):
    """Blockwise fused attention with its gradient; q, k, v: (B, H, T, D),
    Tq == Tk.

    ``causal`` is the top-left square mask (key j visible to query i iff
    j <= i).  Returns O, or ``(O, LSE)`` with LSE (B*H, T) f32 when
    ``return_lse``."""
    _check(q, k, v)
    _block_sizes(q.shape[2], block_q, block_k)
    out, lse = FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale),
                                    block_q, block_k)
    return (out, lse) if return_lse else out
