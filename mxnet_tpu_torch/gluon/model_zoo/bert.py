"""Transformer encoder trunk over stacked per-layer parameters, and the
zoo's masked token cross-entropy.

Counterpart of ``ScanTransformerEncoder`` and ``masked_token_ce`` in
``mxnet_tpu/gluon/model_zoo/bert.py``: the same twelve ``*_stack_*``
parameters plus ``lnf_gamma``/``lnf_beta``, under the same names, so the
serving-checkpoint convention (match by suffix) carries weights across.
The trunk honours ``self.training``: in training mode its dropout draws
from ``random.current_generator``.  BERTModel and the per-layer
``TransformerEncoder`` come with later slices; the JAX package's two
trunk layouts run the same math, so the port holds the stacked one only.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import random as _random
from ...ops.attention import scan_transformer_encoder


def stack_shapes(L, u, h):
    """The trunk's (L, ...) parameter stacks, name -> shape, in the
    order ``scan_transformer_encoder`` takes them (L layers, u units, h
    FFN hidden)."""
    return {
        "qkv_stack_weight": (L, 3 * u, u),
        "qkv_stack_bias": (L, 3 * u),
        "proj_stack_weight": (L, u, u),
        "proj_stack_bias": (L, u),
        "ffn1_stack_weight": (L, h, u),
        "ffn1_stack_bias": (L, h),
        "ffn2_stack_weight": (L, u, h),
        "ffn2_stack_bias": (L, u),
        "ln1_stack_gamma": (L, u),
        "ln1_stack_beta": (L, u),
        "ln2_stack_gamma": (L, u),
        "ln2_stack_beta": (L, u),
    }


class ScanTransformerEncoder(nn.Module):
    """Pre-LN trunk: ``num_layers`` layers of packed-qkv multi-head
    attention and a GELU FFN over (L, ...) parameter stacks, then a
    final LayerNorm.  Input and output (B, T, units)."""

    def __init__(self, num_layers, units, num_heads, hidden_size=None,
                 dropout=0.0, attention_impl="dense", activation="gelu",
                 remat=False, causal=False, lora_rank=0, device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        if lora_rank:
            raise NotImplementedError("LoRA adapters are not ported yet")
        if remat:
            raise NotImplementedError("rematerialisation is not ported yet")
        self._num_layers = num_layers
        self._units = units
        self._num_heads = num_heads
        self._hidden = hidden_size or 4 * units
        self._dropout = dropout
        self._attention_impl = attention_impl
        self._activation = activation
        self._causal = causal
        shapes = stack_shapes(num_layers, units, self._hidden)
        self._stack_names = tuple(shapes)
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device)))
        self.lnf_gamma = nn.Parameter(torch.ones(units, device=device))
        self.lnf_beta = nn.Parameter(torch.zeros(units, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Weights ~ N(0, 0.02) from ``generator`` (default: the next of
        the package chain); biases and LayerNorm shifts 0; LayerNorm
        scales 1.  Served weights are loaded over these (``convert``)."""
        if generator is None:
            generator = _random.step_generator(self.lnf_gamma.device)
        for name in self._stack_names:
            p = getattr(self, name)
            if name.endswith("_weight"):
                p.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("_gamma"):
                p.fill_(1.0)
            else:
                p.zero_()
        self.lnf_gamma.fill_(1.0)
        self.lnf_beta.zero_()

    def forward(self, x):
        stacks = (getattr(self, n) for n in self._stack_names)
        return scan_transformer_encoder(
            x, *stacks, self.lnf_gamma, self.lnf_beta,
            num_heads=self._num_heads, dropout=self._dropout,
            activation=self._activation, impl=self._attention_impl,
            causal=self._causal, training=self.training)


def masked_token_ce(logits, labels):
    """Mean token cross-entropy over valid (label >= 0) positions, from
    the f32 log-softmax, the denominator at least 1: the zoo's one
    masked CE (``gpt.GPTLMLoss`` delegates here)."""
    labels = labels.long()
    valid = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    denom = valid.sum().clamp_min(1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
