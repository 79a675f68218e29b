"""Attention ops for the transformer trunk.

Counterpart of ``mxnet_tpu/ops/attention.py``: ``scaled_dot_product_attention``
(``impl`` "dense" or "flash"), ``multi_head_attention`` with the packed
qkv projection, and ``scan_transformer_encoder``, where the JAX package's
``lax.scan`` over the (L, ...) stacks is a Python loop.  Every op is
differentiable: the flash impl through its autograd Function, the rest
through torch's autograd.

Training mode draws its dropout masks from an explicit generator: the one
passed in, else ``random.current_generator`` (the trainer's per-step
generator).  Left for later slices, and refused loudly: the
"ring"/"ulysses" impls (sequence parallelism), LoRA adapters and
rematerialisation.
"""

from __future__ import annotations

import torch

from .. import random as _random
from .flash_attention import flash_attention
from .nn import activation as _activation
from .nn import dropout as _dropout
from .nn import fully_connected, layer_norm

_NEG = -1e30


def scaled_dot_product_attention(query, key, value, mask=None, causal=False,
                                 scale=None, impl="dense", dropout_p=0.0,
                                 training=True, generator=None):
    """q, k, v: (B, H, T, D).  mask: broadcastable to (B, H, Tq, Tk),
    1 = keep.  Dense causal masking is bottom-right aligned (``tril`` with
    offset Tk - Tq); the flash kernel's is top-left and needs Tq == Tk,
    where the two agree.  ``dropout_p`` drops attention probabilities on
    the dense path when ``training`` (the JAX op's ``_is_training``, True
    for a direct call); the fused impls refuse masks and dropout."""
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
    if dropout_p > 0.0 and training:
        if generator is None:
            generator = _random.current_generator(p.device)
        p = _dropout(p, dropout_p, _key=generator)
    return torch.matmul(p, value.float()).to(query.dtype)


def _split_heads(x, num_heads):
    B, T, C = x.shape
    return x.reshape(B, T, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x):
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def multi_head_attention(query, key, value, qkv_weight=None, qkv_bias=None,
                         proj_weight=None, proj_bias=None, num_heads=1,
                         mask=None, causal=False, impl="dense"):
    """Multi-head attention on (B, T, C) inputs with the packed (3C, C)
    qkv projection, split q | k | v along the output features and then
    into heads, as the JAX op does."""
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


def scan_transformer_encoder(data, qkv_w, qkv_b, proj_w, proj_b, ffn1_w,
                             ffn1_b, ffn2_w, ffn2_b, ln1_g, ln1_b, ln2_g,
                             ln2_b, lnf_g, lnf_b, qkv_lora_a=None,
                             qkv_lora_b=None, num_heads=1, dropout=0.0,
                             activation="gelu", impl="dense", causal=False,
                             remat=False, training=False, generator=None):
    """Pre-LN transformer trunk over stacked (L, ...) per-layer
    parameters: one loop iteration per layer, then the final LayerNorm.
    The FFN products are ``fully_connected``'s: operands in the stream's
    dtype, an f32 accumulator, the result in the stream's dtype, as the
    JAX op's ``preferred_element_type``.  In ``training`` mode with
    ``dropout`` the attention output and the FFN output of every layer are
    dropped (scaled by 1/keep), masks drawn from ``generator`` (default:
    ``random.current_generator``)."""
    if qkv_lora_a is not None or qkv_lora_b is not None:
        raise NotImplementedError("LoRA adapters are not ported yet")
    if remat:
        raise NotImplementedError("rematerialisation is not ported yet")
    use_drop = bool(dropout) and training
    if use_drop and generator is None:
        generator = _random.current_generator(data.device)
    x = data
    for i in range(qkv_w.shape[0]):
        h = layer_norm(x, ln1_g[i], ln1_b[i])
        attn = multi_head_attention(
            h, h, h, qkv_weight=qkv_w[i], qkv_bias=qkv_b[i],
            proj_weight=proj_w[i], proj_bias=proj_b[i],
            num_heads=num_heads, impl=impl, causal=causal)
        if use_drop:
            attn = _dropout(attn, dropout, _key=generator)
        x = x + attn
        h = layer_norm(x, ln2_g[i], ln2_b[i])
        h = fully_connected(h, ffn1_w[i], ffn1_b[i], flatten=False)
        h = _activation(h, activation)
        h = fully_connected(h, ffn2_w[i], ffn2_b[i], flatten=False)
        if use_drop:
            h = _dropout(h, dropout, _key=generator)
        x = x + h
    return layer_norm(x, lnf_g, lnf_b)
