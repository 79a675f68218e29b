"""Attention ops for the transformer trunk.

Counterpart of ``mxnet_tpu/ops/attention.py``, registered under the same
names: ``scaled_dot_product_attention`` (``impl`` "dense" or "flash"),
``multi_head_attention`` with the packed qkv projection, the reference's
interleaved self-attention products
(``_contrib_interleaved_matmul_selfatt_qk`` / ``_valatt``), and
``scan_transformer_encoder``, where the JAX package's ``lax.scan`` over the
(L, ...) stacks is a Python loop.  Every op is differentiable: the flash
impl through its autograd Function, the rest through torch's autograd.

Training mode (``_is_training``, which the ``F``/``nd`` wrappers inject
from ``autograd.is_training()``) draws dropout masks from the generator
``_key`` (the wrappers inject ``random.current_generator``).  The trunk
takes LoRA stacks on its packed qkv weight and the JAX op's remat policies
(``remat.trunk_policy``): a checkpoint per layer, or per chunk of N layers
under ``save_every_k:N``; a region's recompute takes back the masks its
forward drew (``remat``).  Left for later slices, and refused loudly: the
"ring"/"ulysses" impls (sequence parallelism).
"""

from __future__ import annotations

import torch

from .. import random as _random
from .. import remat as _remat
from .._parallel_scope import current_scope
from .flash_attention import flash_attention
from .nn import activation as _activation
from .nn import dropout as _dropout
from .nn import fully_connected, layer_norm
from .registry import register

_NEG = -1e30


@register("scaled_dot_product_attention", random=True, mode_dependent=True)
def scaled_dot_product_attention(query, key, value, mask=None, causal=False,
                                 scale=None, impl="dense", dropout_p=0.0,
                                 _key=None, _is_training=True):
    """q, k, v: (B, H, T, D).  mask: broadcastable to (B, H, Tq, Tk),
    1 = keep.  Dense causal masking is bottom-right aligned (``tril`` with
    offset Tk - Tq); the flash kernel's is top-left and needs Tq == Tk,
    where the two agree.  ``dropout_p`` drops attention probabilities on
    the dense path in training mode, the mask drawn from ``_key`` (default
    ``random.current_generator``); the fused impls refuse masks and
    dropout."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    if impl != "dense" and (mask is not None or dropout_p > 0.0):
        raise NotImplementedError(
            f"attention impl={impl!r} supports only causal masking; "
            "explicit masks / attention dropout require impl='dense'")
    if impl == "flash":
        return flash_attention(query, key, value, causal=causal, scale=scale)
    if impl != "dense":
        raise NotImplementedError(
            f"attention impl={impl!r} is not ported yet (dense, flash)")
    s = torch.matmul(query.float(), key.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        keep = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=s.device).tril(Tk - Tq)
        s = s.masked_fill(~keep, _NEG)
    if mask is not None:
        s = s.masked_fill(~mask.bool(), _NEG)
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0 and _is_training:
        if _key is None:
            _key = _random.current_generator(p.device)
        p = _dropout(p, dropout_p, _key=_key)
    return torch.matmul(p, value.float()).to(query.dtype)


def _split_heads(x, num_heads):
    B, T, C = x.shape
    return x.reshape(B, T, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x):
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def _tp_group(scope, *tensors):
    """The tp group when every one of ``tensors`` (None ones skipped)
    holds a tp shard, None when none does; a mix is a layout the
    tp-aware trunk cannot run and raises."""
    if scope is None or scope.tp_group is None:
        return None
    given = [t for t in tensors if t is not None]
    marks = [scope.shard_of(t) is not None for t in given]
    if not any(marks):
        return None
    if not all(marks):
        from ..base import MXNetError

        raise MXNetError(
            "tensor parallel attention/FFN: the qkv, proj, ffn1 and ffn2 "
            "weights (and the qkv and ffn1 biases) must all be tp shards "
            "(TRANSFORMER_TP_RULES), or none of them")
    return scope.tp_group


@register("multi_head_attention")
def multi_head_attention(query, key, value, qkv_weight=None, qkv_bias=None,
                         proj_weight=None, proj_bias=None, num_heads=1,
                         mask=None, causal=False, impl="dense"):
    """Multi-head attention on (B, T, C) inputs with the packed (3C, C)
    qkv projection, split q | k | v along the output features and then
    into heads, as the JAX op does.

    Inside a sharded step with the qkv and proj weights tp shards
    (``parallel.sharding.local_shard``: the rank's heads of q, k and v,
    and the proj columns of those heads) each rank runs its own heads:
    num_heads / tp of them, the kernels on plain local tensors; the proj
    products are summed over the tp group and the bias added once."""
    group = None
    if qkv_weight is not None and proj_weight is not None:
        group = _tp_group(current_scope(), qkv_weight, qkv_bias,
                          proj_weight)
    return _mha(query, key, value, qkv_weight, qkv_bias, proj_weight,
                proj_bias, num_heads, mask, causal, impl, group)


def _mha(query, key, value, qkv_weight, qkv_bias, proj_weight, proj_bias,
         num_heads, mask, causal, impl, group):
    if group is not None:
        from ..parallel import collectives as coll

        if not (query is key and key is value):
            from ..base import MXNetError

            raise MXNetError("tensor parallel attention takes the packed "
                             "self-attention form (query is key is value)")
        num_heads //= torch.distributed.get_world_size(group)
        query = key = value = coll.copy_to_region(query, group)
        out = _mha(query, key, value, qkv_weight, qkv_bias, proj_weight,
                   None, num_heads, mask, causal, impl, None)
        out = coll.reduce_from_region(out, group)
        return out if proj_bias is None else out + proj_bias
    if qkv_weight is not None:
        if query is key and key is value:
            qkv = torch.matmul(query, qkv_weight.t())
            if qkv_bias is not None:
                qkv = qkv + qkv_bias
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            wq, wk, wv = qkv_weight.chunk(3, dim=0)
            q = torch.matmul(query, wq.t())
            k = torch.matmul(key, wk.t())
            v = torch.matmul(value, wv.t())
            if qkv_bias is not None:
                bq, bk, bv = qkv_bias.chunk(3, dim=0)
                q, k, v = q + bq, k + bk, v + bv
    else:
        q, k, v = query, key, value
    out = scaled_dot_product_attention(
        _split_heads(q, num_heads), _split_heads(k, num_heads),
        _split_heads(v, num_heads), mask=mask, causal=causal, impl=impl)
    out = _merge_heads(out)
    if proj_weight is not None:
        out = torch.matmul(out, proj_weight.t())
        if proj_bias is not None:
            out = out + proj_bias
    return out


def _interleaved(qkv, heads, which):
    """Heads of q, k or v (``which`` 0, 1, 2) from a (T, B, 3C) interleaved
    projection, as (B*heads, T, C/heads)."""
    T, B, C3 = qkv.shape
    d = C3 // 3 // heads
    x = qkv.reshape(T, B, heads, 3 * d)[..., which * d:(which + 1) * d]
    return x.permute(1, 2, 0, 3).reshape(B * heads, T, d)


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=("interleaved_matmul_selfatt_qk",))
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """Input (T, B, 3C) interleaved qkv -> scaled scores (B*heads, T, T)."""
    q = _interleaved(queries_keys_values, heads, 0)
    k = _interleaved(queries_keys_values, heads, 1)
    return torch.matmul(q, k.transpose(1, 2)) * q.shape[-1] ** -0.5


@register("_contrib_interleaved_matmul_selfatt_valatt",
          aliases=("interleaved_matmul_selfatt_valatt",))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """attention (B*heads, T, T) times the interleaved values -> (T, B, C)."""
    T, B, C3 = queries_keys_values.shape
    v = _interleaved(queries_keys_values, heads, 2)
    out = torch.matmul(attention, v)                  # (B*heads, T, d)
    return out.reshape(B, heads, T, -1).permute(2, 0, 1, 3).reshape(
        T, B, C3 // 3)


def _encoder_layer(x, w, num_heads, activation, impl, causal, dropout,
                   generator, tp_group=None):
    """One pre-LN layer on its 12 per-layer parameters ``w``; ``dropout``
    0 (or ``generator`` None) drops nothing.  With ``tp_group`` the qkv,
    proj, ffn1 and ffn2 weights are this rank's tp shards: the attention
    runs the rank's heads and the FFN its hidden columns (ffn1
    column-parallel, ffn2 row-parallel, summed over the group with the
    bias added once); the dropped activations are replicated, so the tp
    ranks draw the same masks."""
    (qw, qb, pw, pb, f1w, f1b, f2w, f2b, g1, b1, g2, b2) = w
    h = layer_norm(x, g1, b1)
    attn = _mha(h, h, h, qw, qb, pw, pb, num_heads, None, causal, impl,
                tp_group)
    if generator is not None:
        attn = _dropout(attn, dropout, _key=generator)
    x = x + attn
    h = layer_norm(x, g2, b2)
    if tp_group is None:
        h = fully_connected(h, f1w, f1b, flatten=False)
        h = _activation(h, activation)
        h = fully_connected(h, f2w, f2b, flatten=False)
    else:
        from ..parallel import collectives as coll

        h = fully_connected(coll.copy_to_region(h, tp_group), f1w, f1b,
                            flatten=False)
        h = _activation(h, activation)
        h = coll.reduce_from_region(
            fully_connected(h, f2w, None, flatten=False), tp_group) + f2b
    if generator is not None:
        h = _dropout(h, dropout, _key=generator)
    return x + h


@register("scan_transformer_encoder", mode_dependent=True, random=True)
def scan_transformer_encoder(data, qkv_w, qkv_b, proj_w, proj_b, ffn1_w,
                             ffn1_b, ffn2_w, ffn2_b, ln1_g, ln1_b, ln2_g,
                             ln2_b, lnf_g, lnf_b, qkv_lora_a=None,
                             qkv_lora_b=None, num_heads=1, dropout=0.0,
                             activation="gelu", impl="dense", causal=False,
                             remat=False, lora_scale=1.0, _is_training=True,
                             _key=None):
    """Pre-LN transformer trunk over stacked (L, ...) per-layer
    parameters: one loop iteration per layer, then the final LayerNorm.
    The FFN products are ``fully_connected``'s: operands in the stream's
    dtype, an f32 accumulator, the result in the stream's dtype, as the
    JAX op's ``preferred_element_type``.

    In training mode with ``dropout`` the attention output and the FFN
    output of every layer are dropped (scaled by 1/keep), masks drawn from
    ``_key`` (default ``random.current_generator``) in layer order.  With
    ``qkv_lora_a`` (L, r, U) and ``qkv_lora_b`` (L, 3U, r) each layer's qkv
    weight is ``qkv + lora_scale * (B @ A)``, the product in f32 and cast
    to the weight's dtype.  ``remat`` (or ``MXTPU_REMAT=save_every_k:N``)
    checkpoints each layer, or each chunk of N layers when N divides L
    (else each layer)."""
    use_drop = bool(dropout) and _is_training
    if use_drop and _key is None:
        _key = _random.current_generator(data.device)
    gen = _key if use_drop else None
    use_lora = qkv_lora_a is not None and qkv_lora_b is not None
    tp_group = _tp_group(current_scope(), qkv_w, qkv_b, proj_w, ffn1_w,
                         ffn1_b, ffn2_w)
    if tp_group is not None and use_lora:
        raise NotImplementedError(
            "scan_transformer_encoder: LoRA stacks under tensor "
            "parallelism wait for the next multi-GPU slice (ROADMAP queue "
            "1 item 1b)")
    L = qkv_w.shape[0]
    stacks = (qkv_w, qkv_b, proj_w, proj_b, ffn1_w, ffn1_b, ffn2_w, ffn2_b,
              ln1_g, ln1_b, ln2_g, ln2_b)

    def layers(x, lo, hi):
        for i in range(lo, hi):
            w = [s[i] for s in stacks]
            if use_lora:
                delta = torch.matmul(qkv_lora_b[i].float(),
                                     qkv_lora_a[i].float())
                w[0] = w[0] + (lora_scale * delta).to(w[0].dtype)
            x = _encoder_layer(x, w, num_heads, activation, impl, causal,
                               dropout, gen, tp_group)
        return x

    pol = _remat.trunk_policy(remat)
    if pol is not None and pol[0] == "every" and (L % pol[1] or pol[1] == 1):
        pol = ("layer", "full")
    x = data
    if pol is None:
        x = layers(x, 0, L)
    else:
        step = pol[1] if pol[0] == "every" else 1
        name = pol[1] if pol[0] == "layer" else "full"
        for lo in range(0, L, step):
            x = _remat.checkpoint(
                lambda y, lo=lo: layers(y, lo, lo + step), name, x)
    return layer_norm(x, lnf_g, lnf_b)
