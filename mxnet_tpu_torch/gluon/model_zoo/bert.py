"""Transformer encoder trunk over stacked per-layer parameters, the BERT
model family, and the zoo's masked token cross-entropy.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``:

- ``ScanTransformerEncoder``: the same twelve ``*_stack_*`` parameters plus
  ``lnf_gamma``/``lnf_beta``, under the same names, so the checkpoint
  convention (match by name) carries weights across;
- ``BERTModel`` (word, token-type and position embeddings, ``embed_ln``,
  the trunk, a tanh pooler on the first position, the NSP classifier, and
  the MLM head: a GELU ``Dense``, a LayerNorm and the decode tied to
  ``word_embed_weight`` plus ``decoder_bias``), ``BERTEmbedding``,
  ``BERTMLMHead``, ``BERTMLMLoss``, ``BERTPretrainLoss`` with
  ``_bert_pretrain_loss_pure``, and ``bert_base``/``bert_large``/
  ``bert_tiny``;
- ``masked_token_ce``, the zoo's one masked CE.

``Dense`` and ``LayerNorm`` here are the two Gluon layers the heads use,
with the Gluon parameter names (``weight``/``bias``, ``gamma``/``beta``):
``initializer``'s suffix dispatch and ``convert``'s name match read them
(``torch.nn.LayerNorm`` names its scale ``weight``, which would send it to
Xavier).  Each module declares its parameters' own inits in
``_param_inits``, as the JAX layers pass ``init=`` to ``params.get``;
``initialize`` applies them over the global initializer.

The models honour ``self.training``: in training mode their dropout draws
from ``random.current_generator``.  They start in eval mode, on ``gpu(0)``
unless ``device`` says otherwise.  ``scan_layers`` is accepted so JAX
call sites port unchanged: the JAX package's two trunk layouts run the
same math, so the port holds the stacked one only
(``convert.load_bert_params`` stacks a per-layer model's weights).  The
per-layer ``TransformerEncoder``/``TransformerEncoderLayer`` and
``bert_pipeline_parts`` come with later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import context
from ... import initializer as _init
from ... import random as _random
from ...base import torch_dtype
from ...ops.attention import scan_transformer_encoder
from ...ops.nn import activation as _activation
from ...ops.nn import dropout as _dropout
from ...ops.nn import fully_connected, layer_norm


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

    # the JAX trunk's own inits: biases and LayerNorm shifts zeros,
    # LayerNorm scales ones (the weights take the global init)
    _param_inits = {n: ("ones" if n.endswith("gamma") else "zeros")
                    for n in (*stack_shapes(0, 0, 0), "lnf_gamma",
                              "lnf_beta")
                    if n.endswith(("bias", "gamma", "beta"))}

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


def _bert_pretrain_loss_pure(nsp_logits, mlm_logits, mlm_labels,
                             nsp_labels):
    """Masked-LM CE over the valid (>= 0) MLM labels plus the mean NSP
    NLL, both from f32 log-softmaxes; labels may be int or float."""
    mlm_loss = masked_token_ce(mlm_logits, mlm_labels)
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_nll = -torch.gather(nsp_logp, -1,
                            nsp_labels.long()[:, None])[:, 0]
    return mlm_loss + nsp_nll.mean()


class BERTPretrainLoss(nn.Module):
    """MLM + NSP loss over ``BERTModel`` outputs: ``outputs`` is (seq,
    pooled, nsp_logits, mlm_logits), ``labels`` is (mlm_labels (B, T) with
    -1 at unmasked positions, nsp_labels (B,))."""

    def forward(self, outputs, labels):
        _seq, _pooled, nsp_logits, mlm_logits = outputs
        mlm_labels, nsp_labels = labels
        return _bert_pretrain_loss_pure(nsp_logits, mlm_logits, mlm_labels,
                                        nsp_labels)


class BERTMLMLoss(nn.Module):
    """Masked-LM cross entropy over head logits; labels (B, T), -1 at
    unmasked positions."""

    def forward(self, logits, labels):
        return masked_token_ce(logits, labels)


class _Initialized(nn.Module):
    """``initialize`` and ``cast`` of the zoo's Gluon-style models."""

    def initialize(self, init="xavier", generator=None):
        """Fill every parameter: each by its own init where its module
        declares one (``_param_inits``), the rest by ``init``'s suffix
        dispatch (default ``Xavier()``, what ``bench_bert`` passes; the
        JAX ``Block.initialize`` defaults to ``Uniform()``), drawing from
        ``generator`` (default: the next of the package chain)."""
        inits = {}
        for prefix, mod in self.named_modules():
            for name, how in getattr(mod, "_param_inits", {}).items():
                inits[f"{prefix}.{name}" if prefix else name] = how
        _init.initialize(self, init, inits, generator)
        return self

    def cast(self, dtype):
        """Every parameter to ``dtype`` (a name or a torch dtype), as the
        JAX ``Block.cast``."""
        return self.to(torch_dtype(dtype))


class LayerNorm(nn.Module):
    """Gluon's ``nn.LayerNorm`` over the last axis: ``gamma`` (ones) and
    ``beta`` (zeros), eps 1e-5."""

    _param_inits = {"gamma": "ones", "beta": "zeros"}

    def __init__(self, units, epsilon=1e-5, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(units, device=device))
        self.beta = nn.Parameter(torch.zeros(units, device=device))

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, eps=self._epsilon)


class Dense(nn.Module):
    """Gluon's ``nn.Dense``: act(x W^T + b) with ``weight`` (units, in)
    and ``bias`` (zeros), through ``fully_connected``."""

    _param_inits = {"bias": "zeros"}

    def __init__(self, units, in_units, activation=None, flatten=True,
                 use_bias=True, device=None):
        super().__init__()
        self._flatten = flatten
        self._activation = activation
        self.weight = nn.Parameter(
            torch.empty((units, in_units), device=device))
        self.bias = (nn.Parameter(torch.zeros(units, device=device))
                     if use_bias else None)

    def forward(self, x):
        out = fully_connected(x, self.weight, self.bias,
                              flatten=self._flatten)
        return out if self._activation is None else _activation(
            out, self._activation)


def _embed(weight, ids):
    """Rows of ``weight`` for integer (or float) ids, clipped into the
    table as the JAX ``Embedding`` (``take(mode="clip")``)."""
    return weight[ids.long().clamp(0, weight.shape[0] - 1)]


class BERTModel(_Initialized):
    """BERT encoder with MLM and NSP heads.  Input (B, T) token ids and
    optional (B, T) token types; output (seq (B, T, units), pooled (B,
    units), nsp_logits (B, 2), mlm_logits (B, T, vocab)), less the heads
    switched off.  Built initialised by ``initialize()`` (Xavier over
    the per-parameter inits); ``initialize(init)`` redraws."""

    def __init__(self, vocab_size=30522, units=768, num_layers=12,
                 num_heads=12, hidden_size=3072, max_length=512,
                 token_types=2, dropout=0.1, attention_impl="dense",
                 use_pooler=True, use_decoder=True, use_classifier=True,
                 scan_layers=False, lora_rank=0, lora_alpha=None,
                 device=None):
        super().__init__()
        if lora_alpha is not None:
            raise NotImplementedError("LoRA adapters are not ported yet")
        device = context.resolve(device)
        self._units = units
        self._vocab = vocab_size
        self._max_length = max_length
        self._dropout = dropout
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier

        def table(rows):
            return nn.Parameter(torch.empty((rows, units), device=device))

        self.word_embed_weight = table(vocab_size)
        self.token_type_embed_weight = table(token_types)
        self.position_embed_weight = table(max_length)
        self._param_inits = {"word_embed_weight": "normal",
                             "token_type_embed_weight": "normal",
                             "position_embed_weight": "normal"}
        self.embed_ln = LayerNorm(units, device=device)
        self.encoder = ScanTransformerEncoder(
            num_layers, units, num_heads, hidden_size, dropout,
            attention_impl, lora_rank=lora_rank, device=device)
        if use_pooler:
            self.pooler = Dense(units, units, activation="tanh",
                                device=device)
        if use_decoder:
            self.decoder_transform = Dense(units, units, activation="gelu",
                                           flatten=False, device=device)
            self.decoder_ln = LayerNorm(units, device=device)
            self.decoder_bias = nn.Parameter(
                torch.zeros(vocab_size, device=device))
            self._param_inits["decoder_bias"] = "zeros"
        if use_classifier:
            # built as the reference builds it, used only with the pooler
            self.nsp_classifier = Dense(2, units, device=device)
        self.initialize()
        self.eval()

    def forward(self, inputs, token_types=None):
        T = inputs.shape[1]
        x = _embed(self.word_embed_weight, inputs)
        if token_types is not None:
            x = x + _embed(self.token_type_embed_weight, token_types)
        else:
            x = x + self.token_type_embed_weight[0:1]
        x = x + self.position_embed_weight[:T]
        x = self.embed_ln(x)
        if self.training and self._dropout:
            x = _dropout(x, self._dropout,
                         _key=_random.current_generator(x.device))
        seq = self.encoder(x)                                 # (B, T, C)
        outputs = [seq]
        if self._use_pooler:
            pooled = self.pooler(seq[:, 0, :])
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.nsp_classifier(pooled))
        if self._use_decoder:
            h = self.decoder_ln(self.decoder_transform(seq))
            outputs.append(fully_connected(h, self.word_embed_weight,
                                           self.decoder_bias, flatten=False))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


class BERTEmbedding(_Initialized):
    """Token + type + position embedding front (the pipeline prologue):
    the token-type table holds segment 0 only, an additive (1, units)
    bias."""

    def __init__(self, vocab_size=30522, units=768, max_length=512,
                 dropout=0.0, device=None):
        super().__init__()
        device = context.resolve(device)
        self._dropout = dropout
        self.word_embed_weight = nn.Parameter(
            torch.empty((vocab_size, units), device=device))
        self.token_type_embed_weight = nn.Parameter(
            torch.empty((1, units), device=device))
        self.position_embed_weight = nn.Parameter(
            torch.empty((max_length, units), device=device))
        self._param_inits = {"word_embed_weight": "normal",
                             "token_type_embed_weight": "normal",
                             "position_embed_weight": "normal"}
        self.embed_ln = LayerNorm(units, device=device)
        self.initialize()
        self.eval()

    def forward(self, inputs):
        T = inputs.shape[1]
        x = _embed(self.word_embed_weight, inputs)
        x = x + self.token_type_embed_weight[0:1]
        x = self.embed_ln(x + self.position_embed_weight[:T])
        if self.training and self._dropout:
            x = _dropout(x, self._dropout,
                         _key=_random.current_generator(x.device))
        return x


class BERTMLMHead(_Initialized):
    """Transform + decode-to-vocab head (the pipeline epilogue), with its
    own, untied decode weight."""

    def __init__(self, vocab_size=30522, units=768, device=None):
        super().__init__()
        device = context.resolve(device)
        self.transform = Dense(units, units, activation="gelu",
                               flatten=False, device=device)
        self.ln = LayerNorm(units, device=device)
        self.decoder = Dense(vocab_size, units, flatten=False,
                             device=device)
        self.initialize()
        self.eval()

    def forward(self, x):
        return self.decoder(self.ln(self.transform(x)))


def bert_base(**kwargs):
    return BERTModel(units=768, num_layers=12, num_heads=12,
                     hidden_size=3072, **kwargs)


def bert_large(**kwargs):
    return BERTModel(units=1024, num_layers=24, num_heads=16,
                     hidden_size=4096, **kwargs)


def bert_tiny(**kwargs):
    """Testing-scale config."""
    kwargs.setdefault("vocab_size", 1024)
    kwargs.setdefault("max_length", 128)
    return BERTModel(units=64, num_layers=2, num_heads=4,
                     hidden_size=128, **kwargs)
