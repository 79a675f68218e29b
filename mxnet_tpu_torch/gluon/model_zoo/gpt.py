"""Decoder-only (GPT-style) language model, its LM loss and its
full-recompute decode, as Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py``: ``GPTModel`` (token +
position embedding, causal pre-LN trunk, LM head tied to the token
embedding; ``scan_layers`` picks the stacked ``ScanTransformerEncoder``,
with LoRA stacks and per-layer remat, over the per-layer
``TransformerEncoder``, both ``trunk_``), ``GPTLMLoss``, the
``gpt2_small``/``gpt2_medium``/``gpt_tiny`` configs, ``STACK_NAMES``,
``extract_decoder_stacks`` (either layout as (L, ...) stacks, for the
serving engine), the pipeline parts' ``GPTEmbedding``/``GPTHead``, and
``generate`` with its helpers ``_windowed_last_logits`` and ``_sample``.
With ``attention_impl="flash"`` the trunk runs the hand-written
flash-attention kernels on a CUDA device, forward and backward.

Dropout follows ``autograd.is_training()`` (the trainers open training
mode), its masks drawn from ``random.current_generator``.  A model is
built initialised on ``device`` (default the card) with N(0, 0.02)
weights, zero biases and unit LayerNorm scales (``bert._ZooModel``).  The
cached decoder, speculative and beam decoding and
``gpt_pipeline_parts`` come with later slices.
"""

from __future__ import annotations

import torch

from ... import initializer as _init
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from .. import nn
from .bert import (ScanTransformerEncoder, TransformerEncoder, _ZooModel,
                   masked_token_ce, stack_shapes)

#: the scanned-trunk parameter stacks every serving decoder runs on
STACK_NAMES = tuple(stack_shapes(0, 0, 0))


class GPTModel(_ZooModel):
    """Token + position embedding -> causal pre-LN trunk -> tied-head
    logits.  Input (B, T) token ids (integer or float); output (B, T,
    vocab) logits."""

    _default_init = _init.Normal(0.02)

    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, hidden_size=None,
                 dropout=0.1, attention_impl="dense", scan_layers=False,
                 remat=False, lora_rank=0, lora_alpha=None, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._vocab = vocab_size
        self._max_length = max_length
        self._dropout = dropout
        if lora_rank and not scan_layers:
            raise ValueError("GPTModel: lora_rank requires "
                             "scan_layers=True (adapters live in the "
                             "scanned trunk)")
        with self.name_scope():
            self.tok_embed_weight = self.params.get(
                "tok_embed_weight", shape=(vocab_size, units))
            self.pos_embed_weight = self.params.get(
                "pos_embed_weight", shape=(max_length, units))
            if scan_layers:
                self.encoder = ScanTransformerEncoder(
                    num_layers, units, num_heads, hidden_size, dropout,
                    attention_impl, causal=True, remat=remat,
                    lora_rank=lora_rank, lora_alpha=lora_alpha,
                    prefix="trunk_")
            else:
                self.encoder = TransformerEncoder(
                    num_layers, units, num_heads, hidden_size, dropout,
                    attention_impl, causal=True, prefix="trunk_")
            if dropout:
                self.drop = nn.Dropout(dropout)
        self._build_init(device)

    def hybrid_forward(self, F, ids, tok_embed_weight, pos_embed_weight):
        x = F.Embedding(ids, tok_embed_weight, input_dim=self._vocab,
                        output_dim=self._units)
        T = ids.shape[1]
        x = x + F.slice_axis(pos_embed_weight, axis=0, begin=0, end=T)
        if self._dropout:
            x = self.drop(x)
        h = self.encoder(x)                       # (B, T, C)
        flat = F.reshape(h, shape=(-1, self._units))
        logits = F.dot(flat, tok_embed_weight, transpose_b=True)
        return F.reshape(logits, shape=(-1, T, self._vocab))


def _lm_loss_pure(logits, labels):
    """Shifted next-token cross-entropy; labels < 0 are ignored: the shift
    plus the zoo's shared masked CE."""
    return masked_token_ce(logits[:, :-1], labels[:, 1:])


class GPTLMLoss(HybridBlock):
    """Causal LM loss: mean next-token NLL over valid (>= 0) labels.  Call
    with (logits, token_ids); the shift happens inside."""

    def hybrid_forward(self, F, logits, labels):
        return _lm_loss_pure(logits, labels)


def _model_device(model):
    return model.tok_embed_weight.data()._data.device


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
    seed tokens (an NDArray, tensor or array).  Returns the (B, T0 +
    max_new_tokens) tokens as a float32 ``NDArray`` on the model's device,
    as the JAX package's ``generate``.

    Every step runs the whole trunk over the right-padded max_length
    window, so with ``attention_impl="flash"`` each new token launches
    the flash kernel once per layer."""
    from ... import context

    device = _model_device(model)
    raw = ids._data if isinstance(ids, NDArray) else ids
    out = torch.as_tensor(raw, device=device).long()
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            nxt = _sample(_windowed_last_logits(model, out), temperature,
                          generator)
            out = torch.cat([out, nxt[:, None]], dim=1)
    return NDArray(out.float(), context.context_of(device))


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


#: per-layer (``TransformerEncoderLayer``) attribute paths of each stack
LAYER_PATHS = {
    "qkv_stack_weight": ("qkv_weight",), "qkv_stack_bias": ("qkv_bias",),
    "proj_stack_weight": ("proj_weight",), "proj_stack_bias": ("proj_bias",),
    "ffn1_stack_weight": ("ffn1_weight",), "ffn1_stack_bias": ("ffn1_bias",),
    "ffn2_stack_weight": ("ffn2_weight",), "ffn2_stack_bias": ("ffn2_bias",),
    "ln1_stack_gamma": ("ln1", "gamma"), "ln1_stack_beta": ("ln1", "beta"),
    "ln2_stack_gamma": ("ln2", "gamma"), "ln2_stack_beta": ("ln2", "beta"),
}


def trunk_parameters(model):
    """The decoder's parameters by serving-checkpoint name: each of
    ``STACK_NAMES`` as a list of Parameters (one, the (L, ...) stack, for
    the scanned trunk; one a layer for the per-layer trunk),
    ``lnf_gamma``/``lnf_beta`` and the two embeddings as one each."""
    enc = model.encoder
    if isinstance(enc, ScanTransformerEncoder):
        out = {n: [getattr(enc, n)] for n in STACK_NAMES}
        out["lnf_gamma"], out["lnf_beta"] = [enc.lnf_gamma], [enc.lnf_beta]
    else:
        layers = list(enc.layers)
        out = {}
        for n, path in LAYER_PATHS.items():
            ps = []
            for layer in layers:
                obj = layer
                for attr in path:
                    obj = getattr(obj, attr)
                ps.append(obj)
            out[n] = ps
        out["lnf_gamma"], out["lnf_beta"] = [enc.ln_f.gamma], [enc.ln_f.beta]
    out["tok_embed_weight"] = [model.tok_embed_weight]
    out["pos_embed_weight"] = [model.pos_embed_weight]
    return out


def extract_decoder_stacks(model):
    """A GPTModel's trunk as (L, ...) stacks, for scanned and per-layer
    trunks alike.  Returns ``(stacks, (lnf_gamma, lnf_beta), tok_embed,
    pos_embed, num_heads, activation)`` as detached tensors: the one
    weight-extraction home of the serving engine."""
    params = trunk_parameters(model)
    enc = model.encoder
    scanned = isinstance(enc, ScanTransformerEncoder)

    def value(name):
        ts = [p.data()._data.detach() for p in params[name]]
        return torch.stack(ts) if name in STACK_NAMES and not scanned \
            else ts[0]

    if scanned:
        num_heads, act = enc._num_heads, enc._activation
    else:
        first = list(enc.layers)[0]
        num_heads, act = first._num_heads, first._activation
    stacks = {n: value(n) for n in STACK_NAMES}
    return (stacks, (value("lnf_gamma"), value("lnf_beta")),
            value("tok_embed_weight"), value("pos_embed_weight"), num_heads,
            act)


# -- pipeline-parallel parts ---------------------------------------------------

class GPTEmbedding(_ZooModel):
    """Token + position embedding front (pipeline prologue)."""

    _default_init = _init.Normal(0.02)

    def __init__(self, vocab_size, units, max_length, dropout=0.0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._vocab = vocab_size
        self._dropout = dropout
        with self.name_scope():
            self.tok_embed_weight = self.params.get(
                "tok_embed_weight", shape=(vocab_size, units))
            self.pos_embed_weight = self.params.get(
                "pos_embed_weight", shape=(max_length, units))
            if dropout:
                self.drop = nn.Dropout(dropout)
        self._build_init(device)

    def hybrid_forward(self, F, ids, tok_embed_weight, pos_embed_weight):
        x = F.Embedding(ids, tok_embed_weight, input_dim=self._vocab,
                        output_dim=self._units)
        x = x + F.slice_axis(pos_embed_weight, axis=0, begin=0,
                             end=ids.shape[1])
        if self._dropout:
            x = self.drop(x)
        return x


class GPTHead(_ZooModel):
    """Final LN + LM projection (pipeline epilogue), untied: the pipeline
    partitions prologue and epilogue parameters separately."""

    _default_init = _init.Normal(0.02)

    def __init__(self, vocab_size, units, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln_f = nn.LayerNorm(in_channels=units)
            self.proj = nn.Dense(vocab_size, in_units=units, flatten=False)
        self._build_init(device)

    def hybrid_forward(self, F, x):
        return self.proj(self.ln_f(x))
