"""Decoder-only (GPT-style) language model, its LM loss and its
full-recompute decode.

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py``: ``GPTModel`` (token +
position embedding, causal pre-LN trunk, LM head tied to the token
embedding), ``GPTLMLoss``, the ``gpt2_small``/``gpt2_medium``/``gpt_tiny``
configs, ``STACK_NAMES``, and ``generate`` with its helpers
``_windowed_last_logits`` and ``_sample``.  With ``attention_impl="flash"``
the trunk runs the hand-written flash-attention kernels on a CUDA device,
forward and backward.

Models start in eval mode; ``model.train()`` turns on the embedding and
trunk dropout, whose masks come from ``random.current_generator`` (the
trainer's per-step generator).  The cached decoder, speculative and beam
decoding and the pipeline parts come with later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import context
from ... import random as _random
from ...ops.nn import dropout as _dropout
from .bert import ScanTransformerEncoder, masked_token_ce, stack_shapes

#: the trunk's parameter stacks every serving decoder runs on
STACK_NAMES = tuple(stack_shapes(0, 0, 0))


class GPTModel(nn.Module):
    """Token + position embedding -> causal pre-LN trunk -> tied-head
    logits.  Input (B, T) integer token ids; output (B, T, vocab) logits.

    ``device`` defaults to ``gpu(0)`` and raises when no card is present;
    pass ``context.cpu()`` to run on the host.  ``scan_layers`` is
    accepted so JAX call sites port unchanged: the JAX package's stacked
    and per-layer trunks run the same math, and the port holds the
    stacked one (``convert.load_stacks`` carries a per-layer model's
    weights across)."""

    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, hidden_size=None,
                 dropout=0.1, attention_impl="dense", scan_layers=False,
                 remat=False, lora_rank=0, device=None):
        super().__init__()
        device = context.resolve(device)
        self._units = units
        self._vocab = vocab_size
        self._max_length = max_length
        self._dropout = dropout
        self.tok_embed_weight = nn.Parameter(
            torch.empty((vocab_size, units), device=device))
        self.pos_embed_weight = nn.Parameter(
            torch.empty((max_length, units), device=device))
        self.encoder = ScanTransformerEncoder(
            num_layers, units, num_heads, hidden_size, dropout,
            attention_impl, causal=True, remat=remat, lora_rank=lora_rank,
            device=device)
        self.reset_parameters()
        self.eval()

    @torch.no_grad()
    def reset_parameters(self):
        """Weights ~ N(0, 0.02) drawn from one generator of the package
        chain (``random.seed`` makes them reproducible)."""
        g = _random.step_generator(self.tok_embed_weight.device)
        self.tok_embed_weight.normal_(0.0, 0.02, generator=g)
        self.pos_embed_weight.normal_(0.0, 0.02, generator=g)
        self.encoder.reset_parameters(g)

    def forward(self, ids):
        T = ids.shape[1]
        x = self.tok_embed_weight[ids.long()] + self.pos_embed_weight[:T]
        if self.training and self._dropout:
            x = _dropout(x, self._dropout,
                         _key=_random.current_generator(x.device))
        h = self.encoder(x)                                   # (B, T, C)
        return torch.matmul(h, self.tok_embed_weight.t())     # tied head


def _lm_loss_pure(logits, labels):
    """Shifted next-token cross-entropy; labels < 0 are ignored: the shift
    plus the zoo's shared masked CE."""
    return masked_token_ce(logits[:, :-1], labels[:, 1:])


class GPTLMLoss(nn.Module):
    """Causal LM loss: mean next-token NLL over valid (>= 0) labels.  Call
    with (logits, token_ids); the shift happens inside."""

    def forward(self, logits, labels):
        return _lm_loss_pure(logits, labels)


def _windowed_last_logits(model, flat):
    """Last-position logits for (N, T) token rows through the model's
    fixed max_length window: right-pad to W with token 0 and read
    position cur-1; causal masking hides the pad from that position."""
    W = model._max_length
    ctx = flat[:, -W:]
    cur = ctx.shape[1]
    if cur < W:
        ctx = torch.cat([ctx, ctx.new_zeros((ctx.shape[0], W - cur))],
                        dim=1)
    return model(ctx)[:, cur - 1]


def _sample(last, temperature, generator=None):
    """Next tokens from (B, vocab) logits: greedy (the first maximum, as
    numpy's argmax), or softmax sampling at ``temperature`` drawn with
    ``generator`` (on the logits' device)."""
    if temperature:
        p = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(p, 1, generator=generator)[:, 0]
    return last.argmax(dim=-1)


def generate(model, ids, max_new_tokens=16, temperature=None,
             generator=None):
    """Greedy (or sampled) decode by full recompute per step; ids: (B, T0)
    seed tokens (tensor or array).  Returns (B, T0 + max_new_tokens)
    int64 tokens on the model's device.

    Every step runs the whole trunk over the right-padded max_length
    window, so with ``attention_impl="flash"`` each new token launches
    the flash kernel once per layer."""
    device = model.tok_embed_weight.device
    out = torch.as_tensor(ids, device=device).long()
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            nxt = _sample(_windowed_last_logits(model, out), temperature,
                          generator)
            out = torch.cat([out, nxt[:, None]], dim=1)
    return out


def gpt2_small(**kwargs):
    """GPT-2 124M config."""
    kwargs.setdefault("vocab_size", 50257)
    kwargs.setdefault("units", 768)
    kwargs.setdefault("num_layers", 12)
    kwargs.setdefault("num_heads", 12)
    kwargs.setdefault("max_length", 1024)
    return GPTModel(**kwargs)


def gpt2_medium(**kwargs):
    kwargs.setdefault("vocab_size", 50257)
    kwargs.setdefault("units", 1024)
    kwargs.setdefault("num_layers", 24)
    kwargs.setdefault("num_heads", 16)
    kwargs.setdefault("max_length", 1024)
    return GPTModel(**kwargs)


def gpt_tiny(**kwargs):
    """Test-sized config."""
    kwargs.setdefault("vocab_size", 128)
    kwargs.setdefault("units", 32)
    kwargs.setdefault("num_layers", 2)
    kwargs.setdefault("num_heads", 2)
    kwargs.setdefault("max_length", 64)
    kwargs.setdefault("dropout", 0.0)
    return GPTModel(**kwargs)
