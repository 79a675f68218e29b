"""Sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``mxnet_tpu/parallel/ring.py``.  The JAX package runs both
inside ``shard_map`` over global arrays; here each rank of the ``sp``
group holds its block of T/p positions of every sequence, (B, H, T/p, D),
and the exchanges are explicit:

- **Ring attention** (Liu et al. 2023): Q stays; the K/V blocks travel one
  hop a step around the group (``collectives.ppermute``), p steps in all.
  Each step runs the flash forward on the block present and folds its
  normalised output and LSE into the running output with the stable
  ``logaddexp`` combine.  Causal attention works at block granularity: a
  block j < i runs the full kernel, j == i the causal one, and j > i
  launches nothing (zeros with LSE -1e30).  The backward is a second ring
  pass through the dQ and dK/dV kernels, fed the GLOBAL output and LSE
  (the dQ kernel's D = rowsum(dO * O) is then the global one); the dK and
  dV accumulators travel with their block and arrive home after p hops.
  ``RingAttention`` (a ``torch.autograd.Function``) joins the passes.
- **Ulysses** (DeepSpeed-Ulysses): an all-to-all from sequence shards to
  head shards, flash attention over the whole T for H/p heads, and the
  all-to-all back.

On CUDA tensors every block goes through the hand-written kernels
(``flash_attention_fwd``, ``flash_attention_dq``, ``flash_attention_dkv``);
a head dim they are not built for raises, as it does for ``flash``.  On
host tensors the blocks run the kernels' plain versions.  There is no
dense path and no library kernel.

The group is ``group=``, else ``mesh``'s ``axis`` group, else the open
sharded step's sp group (``collectives.parallel_scope``).  With none,
q, k and v hold the whole sequence and both reduce to flash attention
over it: outside a sharded step a rank's arrays are global, as the JAX
package's are, so the process default mesh is not read.  ``_compat`` (``pvary``) and ``_place``/``_uncommit``
are JAX plumbing with no counterpart here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._parallel_scope import current_scope
from ..ops import flash_attention as _fa
from . import collectives as _coll
from .mesh import SP

_NEG_INF = -1e30


def _group(mesh, axis, group):
    if group is not None:
        return group
    if mesh is not None:
        return mesh.group(axis)
    scope = current_scope()
    return None if scope is None else scope.sp_group


def _block_fwd(q, k, v, causal, scale):
    """One KV block's flash forward: (O like q, LSE (B, H, T) f32)."""
    B, H, T, _ = q.shape
    if q.device.type == "cuda":
        out, lse = _fa.flash_attention_fwd(q, k, v, causal, scale)
    else:
        out, lse = _fa.flash_attention_plain(q, k, v, causal, scale)
    return out, lse.reshape(B, H, T)


def _block_bwd(q, k, v, out, lse, g, causal, scale):
    """One KV block's flash backward with the GLOBAL O and LSE ((B*H, T)
    f32): (dQ, dK, dV)."""
    if q.device.type == "cuda":
        return _fa.flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    return _fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal, scale)


def _kind(i, j, causal):
    """What block j does for the queries of rank i: "full", "diag" or
    "skip" (causal at block granularity)."""
    if not causal or j < i:
        return "full"
    return "diag" if j == i else "skip"


def _combine(o, lse, o_blk, lse_blk):
    """Fold one block's normalised output and LSE into the running f32
    ones by the stable ``logaddexp``: (o, lse)."""
    lse_new = torch.logaddexp(lse, lse_blk)
    return (o * torch.exp(lse - lse_new)[..., None]
            + o_blk.float() * torch.exp(lse_blk - lse_new)[..., None],
            lse_new)


def _ring_fwd(q, k, v, group, causal, scale):
    p = dist.get_world_size(group) if group is not None else 1
    i = dist.get_rank(group) if group is not None else 0
    B, H, T, D = q.shape
    perm = [(r, (r + 1) % p) for r in range(p)]
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, T), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v])
    for step in range(p):
        j = (i - step) % p
        kind = _kind(i, j, causal)
        if kind == "skip":
            o_blk = torch.zeros_like(q)
            lse_blk = torch.full_like(lse, _NEG_INF)
        else:
            o_blk, lse_blk = _block_fwd(q, kv[0], kv[1], kind == "diag",
                                        scale)
        o, lse = _combine(o, lse, o_blk, lse_blk)
        if step < p - 1:
            kv = _coll.ppermute(kv, perm, group, "ring_kv")
    return o.to(q.dtype), lse


def _ring_bwd(q, k, v, out, lse, g, group, causal, scale):
    p = dist.get_world_size(group) if group is not None else 1
    i = dist.get_rank(group) if group is not None else 0
    B, H, T, D = q.shape
    perm = [(r, (r + 1) % p) for r in range(p)]
    lse_rows = lse.reshape(B * H, T).contiguous()
    g = g.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    # K, V and their dK, dV accumulators travel together
    kv = torch.stack([k, v])
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=q.device)
    for step in range(p):
        j = (i - step) % p
        kind = _kind(i, j, causal)
        if kind != "skip":
            dq_b, dk_b, dv_b = _block_bwd(q, kv[0], kv[1], out, lse_rows, g,
                                          kind == "diag", scale)
            dq += dq_b.float()
            dkv[0] += dk_b.float()
            dkv[1] += dv_b.float()
        if step < p - 1:
            kv = _coll.ppermute(kv, perm, group, "ring_kv")
        dkv = _coll.ppermute(dkv, perm, group, "ring_dkv")
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Ring attention with its gradient (the JAX package's ``custom_vjp``
    ``_ring_flash``): forward saves q, k, v, the global O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        q, k, v = (x.contiguous() for x in (q, k, v))
        out, lse = _ring_fwd(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.args
        return (*_ring_bwd(q, k, v, out, lse, g, group, causal, scale),
                None, None, None)


def _check(q, k, v, what):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{what}: q, k, v must share one local (B, H, T/p, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")


def ring_attention(q, k, v, mesh=None, axis=SP, causal=False, scale=None,
                   group=None):
    """Attention over the sequence sharded across the ``axis`` group.

    q, k, v: this rank's (B, H, T/p, D) block, rank r holding positions
    [r T/p, (r+1) T/p) of every sequence.  Returns this rank's block of
    the output.  ``causal`` masks at global positions (block granularity
    between ranks, the kernel's top-left mask on the diagonal block)."""
    _check(q, k, v, "ring_attention")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return RingAttention.apply(q, k, v, _group(mesh, axis, group),
                               bool(causal), float(scale))


class _SeqToHead(torch.autograd.Function):
    """(B, H, T/p, D) sequence shards -> (B, H/p, T, D) head shards over
    ``group`` (backward: the inverse exchange)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq2head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head2seq(g, ctx.group), None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head2seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq2head(g, ctx.group), None


def _exchange(x, group):
    out = torch.empty_like(x)
    with _coll._timed("ulysses_all_to_all", x):
        dist.all_to_all_single(out, x, group=group)
    return out


def _seq2head(x, group):
    p = dist.get_world_size(group)
    B, H, T, D = x.shape
    # chunk j (heads [j H/p, (j+1) H/p)) goes to rank j; chunk j back is
    # rank j's positions of this rank's heads
    send = x.reshape(B, p, H // p, T, D).transpose(0, 1).contiguous()
    recv = _exchange(send, group)                  # (p, B, H/p, T, D)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, H // p, p * T, D)


def _head2seq(x, group):
    p = dist.get_world_size(group)
    B, Hp, Tf, D = x.shape
    send = x.reshape(B, Hp, p, Tf // p, D).permute(2, 0, 1, 3, 4) \
        .contiguous()                              # (p, B, H/p, T/p, D)
    recv = _exchange(send, group)                  # chunk j: rank j's heads
    return recv.transpose(0, 1).reshape(B, p * Hp, Tf // p, D)


def ulysses_attention(q, k, v, mesh=None, axis=SP, causal=False, scale=None,
                      group=None):
    """All-to-all head <-> sequence attention (DeepSpeed-Ulysses).

    q, k, v: this rank's (B, H, T/p, D) block; H must be divisible by the
    group's size.  Flash attention runs over the whole sequence for H/p
    heads between the two exchanges."""
    _check(q, k, v, "ulysses_attention")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = _group(mesh, axis, group)
    if group is None:
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    p = dist.get_world_size(group)
    if q.shape[1] % p:
        from ..base import MXNetError

        raise MXNetError(f"ulysses: num_heads {q.shape[1]} not divisible by "
                         f"sp size {p}")
    qf, kf, vf = (_SeqToHead.apply(x.contiguous(), group)
                  for x in (q, k, v))
    of = _fa.flash_attention(qf, kf, vf, causal=causal, scale=scale)
    return _HeadToSeq.apply(of.contiguous(), group)
