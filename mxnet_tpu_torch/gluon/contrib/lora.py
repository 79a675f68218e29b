"""LoRA, low-rank adaptation for fine-tuning (Hu et al. 2021).

Counterpart of ``mxnet_tpu/gluon/contrib/lora.py``: freeze the pretrained
weight W and learn a rank-r update ``(alpha / r) * B @ A``, so the tuned
layer computes ``y = x (W + dW)^T + b``.

- ``LoRADense``: an ``nn.Dense`` that shares a built ``Dense``'s frozen
  weight and bias and owns trainable ``lora_a`` (normal) and ``lora_b``
  (zeros), so it starts equal to the base; ``merge()`` folds the adapter
  into the base weight;
- ``apply_lora(net, rank, alpha, patterns)``: re-parameterise the matching
  ``nn.Dense`` children of a built network in place and freeze every
  other parameter;
- ``freeze_for_lora(net)``: freeze every parameter whose name lacks
  "lora" (models with built-in adapters: the trunk's ``lora_rank``).

Each change bumps the blocks' ``_cache_version``, so a captured
``Trainer.train_step`` records the step again.  Adapters are initialised
where their base weight lives.
"""

from __future__ import annotations

import re

import numpy as _np
import torch

from ..block import HybridBlock
from .. import nn


class LoRADense(nn.Dense):
    """Dense with a frozen base weight and a trainable low-rank update.

    ``base`` (an initialised ``nn.Dense``) donates its weight and bias
    parameters, which are frozen (``grad_req='null'``) and keep their
    names; A is drawn normal, B is zeros."""

    def __init__(self, base, rank=8, alpha=16.0, **kwargs):
        if not isinstance(base, nn.Dense):
            raise TypeError(f"LoRADense wraps nn.Dense, got {type(base)}")
        HybridBlock.__init__(self, **kwargs)  # skip Dense.__init__
        units, in_units = base.weight.shape
        if not in_units:
            raise ValueError(
                "LoRADense: base Dense has deferred (unknown) in_units; "
                "run a forward pass (or pass in_units=) before wrapping")
        self._units = units
        self._in_units = in_units
        self._rank = int(rank)
        self._scale = float(alpha) / self._rank
        self._flatten = base._flatten
        self.act = base.act
        dtype = base.weight.dtype
        with self.name_scope():
            self.weight = base.weight
            self.weight.grad_req = "null"
            self.bias = base.bias
            if self.bias is not None:
                self.bias.grad_req = "null"
            self.params.update(base.params)
            self.lora_a = self.params.get(
                "lora_a", shape=(self._rank, in_units), init="normal",
                dtype=dtype)
            self.lora_b = self.params.get(
                "lora_b", shape=(units, self._rank), init="zeros",
                dtype=dtype)

    def hybrid_forward(self, F, x, weight, lora_a, lora_b, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        down = F.FullyConnected(x, lora_a, None, num_hidden=self._rank,
                                no_bias=True, flatten=self._flatten)
        up = F.FullyConnected(down, lora_b, None, num_hidden=self._units,
                              no_bias=True, flatten=False)
        out = out + self._scale * up
        if self.act is not None:
            out = self.act(out)
        return out

    def merge(self):
        """Fold the adapter into the base weight and zero B; returns the
        (shared) base weight's NDArray.  A captured step keyed on this
        block records again."""
        w = self.weight.data()
        a, b = self.lora_a.data()._data, self.lora_b.data()._data
        with torch.no_grad():
            delta = torch.matmul(b, a)
            self.weight.set_data(w._data + self._scale * delta)
            self.lora_b.set_data(torch.zeros_like(b))
        self._clear_cached_op()
        return self.weight.data()


def _clear_tree(block):
    block._clear_cached_op()
    for c in block._children.values():
        _clear_tree(c)


def freeze_for_lora(net):
    """Freeze every parameter whose name does not contain 'lora' (models
    built with adapters: ``ScanTransformerEncoder(lora_rank=r)``, a
    ``BERTModel``/``GPTModel`` with ``scan_layers=True, lora_rank=r``).
    Returns (n_trainable, n_total) parameter counts."""
    n_train = n_total = 0
    for name, p in net.collect_params().items():
        n = int(_np.prod(p.shape)) if p.shape else 0
        n_total += n
        if "lora" in name:
            n_train += n
        else:
            p.grad_req = "null"
    if n_train == 0:
        raise ValueError("freeze_for_lora: net has no 'lora' params; "
                         "build it with lora_rank=... first")
    _clear_tree(net)
    return n_train, n_total


def apply_lora(net, rank=8, alpha=16.0, patterns=(".*",)):
    """Re-parameterise the ``nn.Dense`` children of ``net`` whose name
    matches one of ``patterns`` with LoRA adapters, in place, and freeze
    every other parameter.  Returns the new ``LoRADense`` blocks.  Call
    after the net is initialised and its shapes are known."""
    regs = [re.compile(p) for p in patterns]
    wrapped = []

    def visit(block):
        for name, child in list(block._children.items()):
            if isinstance(child, nn.Dense) and \
                    not isinstance(child, LoRADense) and \
                    any(r.search(child.name) for r in regs):
                ld = LoRADense(child, rank=rank, alpha=alpha,
                               prefix=child.prefix + "lora_")
                ctx = child.weight.list_ctx()[0]
                ld.lora_a.initialize(ctx=ctx)
                ld.lora_b.initialize(ctx=ctx)
                # register_child replaces the child under its attribute
                # name, so block.<name> is the adapter from now on
                block.register_child(ld, name)
                wrapped.append(ld)
            else:
                visit(child)

    visit(net)
    _clear_tree(net)
    if not wrapped:
        raise ValueError(f"apply_lora: no nn.Dense matched {patterns}")
    lora_ids = {id(b.lora_a) for b in wrapped} \
        | {id(b.lora_b) for b in wrapped}
    for p in net.collect_params().values():
        if id(p) not in lora_ids:
            p.grad_req = "null"
    return wrapped
