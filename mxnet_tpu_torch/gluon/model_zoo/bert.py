"""Transformer encoder / BERT model family, as Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``, block for block and
name for name: ``TransformerEncoderLayer``, ``TransformerEncoder`` (the
per-layer trunk, ``layer{i}_`` children), ``ScanTransformerEncoder`` (the
same layers over (L, ...) ``*_stack_*`` parameters, with optional LoRA
stacks and per-layer remat), ``BERTModel`` (``scan_layers`` picks the
trunk), ``BERTEmbedding``, ``BERTMLMHead``, ``BERTMLMLoss``,
``BERTPretrainLoss`` with ``_bert_pretrain_loss_pure``, ``bert_base``/
``bert_large``/``bert_tiny``, and ``masked_token_ce``, the zoo's one
masked CE.  Their ``collect_params()`` names are the JAX package's
(``bertmodel0_enc_layer0_qkv_weight``, ``bertmodel0_pooler_weight`` ...),
so weights carry across by name (``convert.load_gluon_params``).

Each ``hybrid_forward`` runs on tensors through ``F`` (the port's op
registry), so dropout follows ``autograd.is_training()`` and draws from
``random.current_generator``, as every Gluon layer here does.

A zoo model is built initialised on ``device`` (default
``current_context()``, the card): ``BERTModel`` with ``Xavier()`` over
each parameter's own init (normal embedding tables, zero biases, unit
LayerNorm scales).  Its ``initialize`` redraws every parameter (where the
model lives unless ``ctx`` says otherwise); the JAX package's leaves a
built model uninitialised, so a ported ``net.initialize(init)`` call has
the same effect there and here.  ``bert_pipeline_parts`` waits for the
pipeline slice.
"""

from __future__ import annotations

import torch

from ... import context
from ..._parallel_scope import current_scope
from ... import initializer as _init
from ..block import HybridBlock
from .. import nn


class _ZooModel(HybridBlock):
    """``initialize`` of the zoo's language models: every parameter
    redrawn (``force_reinit``), on the model's device by default, with the
    model's own default initializer.  Built in eval mode (torch's flag; a
    Gluon block's layers follow ``autograd.is_training()``)."""

    _default_init = "xavier"

    def _build_init(self, device):
        self._zoo_ctx = context.context_of(context.resolve(device))
        self.initialize()
        self.eval()

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=True, generator=None):
        super().initialize(
            _init.create(init if init is not None else self._default_init),
            ctx if ctx is not None else self._zoo_ctx, verbose, force_reinit,
            generator)


class TransformerEncoderLayer(HybridBlock):
    """Pre-LN transformer encoder layer."""

    def __init__(self, units, num_heads, hidden_size=None, dropout=0.1,
                 attention_impl="dense", activation="gelu",
                 causal=False, **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        self._units = units
        self._num_heads = num_heads
        hidden_size = hidden_size or 4 * units
        self._attention_impl = attention_impl
        self._dropout = dropout
        self._activation = activation
        self._causal = causal
        with self.name_scope():
            self.qkv_weight = self.params.get("qkv_weight",
                                              shape=(3 * units, units))
            self.qkv_bias = self.params.get("qkv_bias", shape=(3 * units,),
                                            init="zeros")
            self.proj_weight = self.params.get("proj_weight",
                                               shape=(units, units))
            self.proj_bias = self.params.get("proj_bias", shape=(units,),
                                             init="zeros")
            self.ffn1_weight = self.params.get("ffn1_weight",
                                               shape=(hidden_size, units))
            self.ffn1_bias = self.params.get("ffn1_bias",
                                             shape=(hidden_size,),
                                             init="zeros")
            self.ffn2_weight = self.params.get("ffn2_weight",
                                               shape=(units, hidden_size))
            self.ffn2_bias = self.params.get("ffn2_bias", shape=(units,),
                                             init="zeros")
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ln2 = nn.LayerNorm(in_channels=units)
            if dropout:
                self.drop = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, qkv_weight, qkv_bias, proj_weight,
                       proj_bias, ffn1_weight, ffn1_bias, ffn2_weight,
                       ffn2_bias, mask=None):
        h = self.ln1(x)
        attn = F.multi_head_attention(
            h, h, h, qkv_weight=qkv_weight, qkv_bias=qkv_bias,
            proj_weight=proj_weight, proj_bias=proj_bias,
            num_heads=self._num_heads, mask=mask,
            impl=self._attention_impl, causal=self._causal)
        if self._dropout:
            attn = self.drop(attn)
        x = x + attn
        h = self.ln2(x)
        h = F.FullyConnected(h, ffn1_weight, ffn1_bias,
                             num_hidden=ffn1_weight.shape[0],
                             flatten=False)
        h = F.Activation(h, act_type=self._activation)
        h = F.FullyConnected(h, ffn2_weight, ffn2_bias,
                             num_hidden=ffn2_weight.shape[0],
                             flatten=False)
        if self._dropout:
            h = self.drop(h)
        return x + h


class TransformerEncoder(HybridBlock):
    """The per-layer trunk: ``num_layers`` ``TransformerEncoderLayer``s
    (``layer{i}_``) and a final LayerNorm."""

    def __init__(self, num_layers, units, num_heads, hidden_size=None,
                 dropout=0.1, attention_impl="dense", causal=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._num_layers = num_layers
        with self.name_scope():
            self.layers = nn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.layers.add(TransformerEncoderLayer(
                    units, num_heads, hidden_size, dropout,
                    attention_impl, causal=causal,
                    prefix=f"layer{i}_"))
            self.ln_f = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x):
        x = self.layers(x)
        return self.ln_f(x)


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


class ScanTransformerEncoder(HybridBlock):
    """The trunk over stacked per-layer parameters (``*_stack_*``, the
    layer dim first) and ``lnf_gamma``/``lnf_beta``: the same pre-LN math
    as ``TransformerEncoder``, one ``scan_transformer_encoder`` op.  With
    ``lora_rank`` r it holds ``qkv_lora_a`` (L, r, u), normal, and
    ``qkv_lora_b`` (L, 3u, r), zeros, so the adapted trunk starts equal to
    the base, scaled by ``lora_alpha / r`` (default alpha 2r); ``remat``
    checkpoints each layer."""

    def __init__(self, num_layers, units, num_heads, hidden_size=None,
                 dropout=0.1, attention_impl="dense",
                 activation="gelu", remat=False, causal=False,
                 lora_rank=0, lora_alpha=None, **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        hidden_size = hidden_size or 4 * units
        self._remat = bool(remat)
        self._causal = causal
        self._num_layers = num_layers
        self._units = units
        self._num_heads = num_heads
        self._hidden = hidden_size
        self._dropout = dropout
        self._attention_impl = attention_impl
        self._activation = activation
        self._lora_rank = int(lora_rank)
        if lora_rank:
            alpha = (float(lora_alpha) if lora_alpha is not None
                     else 2.0 * lora_rank)
            self._lora_scale = alpha / lora_rank
        else:
            self._lora_scale = 0.0
        inits = {"bias": "zeros", "beta": "zeros", "gamma": "ones"}
        with self.name_scope():
            for name, shape in stack_shapes(num_layers, units,
                                            hidden_size).items():
                setattr(self, name, self.params.get(
                    name, shape=shape, init=inits.get(name.split("_")[-1])))
            self.lnf_gamma = self.params.get("lnf_gamma", shape=(units,),
                                             init="ones")
            self.lnf_beta = self.params.get("lnf_beta", shape=(units,),
                                            init="zeros")
            if self._lora_rank:
                r = self._lora_rank
                self.qkv_lora_a = self.params.get(
                    "qkv_lora_a", shape=(num_layers, r, units),
                    init="normal")
                self.qkv_lora_b = self.params.get(
                    "qkv_lora_b", shape=(num_layers, 3 * units, r),
                    init="zeros")

    def hybrid_forward(self, F, x, qkv_stack_weight, qkv_stack_bias,
                       proj_stack_weight, proj_stack_bias,
                       ffn1_stack_weight, ffn1_stack_bias,
                       ffn2_stack_weight, ffn2_stack_bias,
                       ln1_stack_gamma, ln1_stack_beta,
                       ln2_stack_gamma, ln2_stack_beta,
                       lnf_gamma, lnf_beta, qkv_lora_a=None,
                       qkv_lora_b=None):
        kw = {}
        if qkv_lora_a is not None:
            kw = {"qkv_lora_a": qkv_lora_a, "qkv_lora_b": qkv_lora_b,
                  "lora_scale": self._lora_scale}
        return F.scan_transformer_encoder(
            x, qkv_stack_weight, qkv_stack_bias, proj_stack_weight,
            proj_stack_bias, ffn1_stack_weight, ffn1_stack_bias,
            ffn2_stack_weight, ffn2_stack_bias, ln1_stack_gamma,
            ln1_stack_beta, ln2_stack_gamma, ln2_stack_beta,
            lnf_gamma, lnf_beta, num_heads=self._num_heads,
            dropout=self._dropout, activation=self._activation,
            impl=self._attention_impl, causal=self._causal,
            remat=self._remat, **kw)


class BERTModel(_ZooModel):
    """BERT encoder with MLM and NSP heads.  Input (B, T) token ids and
    optional (B, T) token types; output (seq (B, T, units), pooled (B,
    units), nsp_logits (B, 2), mlm_logits (B, T, vocab)), less the heads
    switched off.  ``scan_layers`` picks ``ScanTransformerEncoder`` (with
    ``lora_rank``/``lora_alpha``) over the per-layer
    ``TransformerEncoder``; both are ``enc_``."""

    def __init__(self, vocab_size=30522, units=768, num_layers=12,
                 num_heads=12, hidden_size=3072, max_length=512,
                 token_types=2, dropout=0.1, attention_impl="dense",
                 use_pooler=True, use_decoder=True, use_classifier=True,
                 scan_layers=False, lora_rank=0, lora_alpha=None,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if lora_rank and not scan_layers:
            raise ValueError("BERTModel: lora_rank requires "
                             "scan_layers=True (adapters live in the "
                             "scanned trunk)")
        self._units = units
        self._vocab = vocab_size
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        with self.name_scope():
            self.word_embed_weight = self.params.get(
                "word_embed_weight", shape=(vocab_size, units),
                init="normal")
            self.token_type_embed_weight = self.params.get(
                "token_type_embed_weight", shape=(token_types, units),
                init="normal")
            self.position_embed_weight = self.params.get(
                "position_embed_weight", shape=(max_length, units),
                init="normal")
            self.embed_ln = nn.LayerNorm(in_channels=units)
            if dropout:
                self.embed_drop = nn.Dropout(dropout)
            self._dropout = dropout
            if scan_layers:
                self.encoder = ScanTransformerEncoder(
                    num_layers, units, num_heads, hidden_size, dropout,
                    attention_impl, lora_rank=lora_rank,
                    lora_alpha=lora_alpha, prefix="enc_")
            else:
                self.encoder = TransformerEncoder(
                    num_layers, units, num_heads, hidden_size, dropout,
                    attention_impl, prefix="enc_")
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       in_units=units, prefix="pooler_")
            if use_decoder:
                # MLM head: transform + tied-embedding decode
                self.decoder_transform = nn.Dense(
                    units, activation="gelu", in_units=units,
                    flatten=False, prefix="dec_transform_")
                self.decoder_ln = nn.LayerNorm(in_channels=units)
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,), init="zeros")
            if use_classifier:
                self.nsp_classifier = nn.Dense(2, in_units=units,
                                               prefix="nsp_")
        self._build_init(device)

    def hybrid_forward(self, F, inputs, token_types=None,
                       word_embed_weight=None, token_type_embed_weight=None,
                       position_embed_weight=None, decoder_bias=None):
        T = inputs.shape[1]
        x = F.Embedding(inputs, word_embed_weight)
        if token_types is not None:
            x = x + F.Embedding(token_types, token_type_embed_weight)
        else:
            x = x + token_type_embed_weight[0:1]
        x = x + position_embed_weight[:T]
        x = self.embed_ln(x)
        if self._dropout:
            x = self.embed_drop(x)
        seq = self.encoder(x)  # (B, T, C)
        outputs = [seq]
        if self._use_pooler:
            pooled = self.pooler(seq[:, 0, :])
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.nsp_classifier(pooled))
        if self._use_decoder:
            h = self.decoder_transform(seq)
            h = self.decoder_ln(h)
            logits = F.FullyConnected(
                h, word_embed_weight, decoder_bias,
                num_hidden=word_embed_weight.shape[0], flatten=False)
            outputs.append(logits)
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


def masked_token_ce(logits, labels):
    """Mean token cross-entropy over valid (label >= 0) positions, from
    the f32 log-softmax, the denominator at least 1: the zoo's one
    masked CE (``gpt.GPTLMLoss`` delegates here).

    Inside a sharded step over dp ranks the mean is the global batch's,
    as the JAX package's over a dp-sharded array: the valid count is
    summed over the dp group, and a rank returns its share of the global
    mean times dp (the trainer's objective is the mean over the dp ranks
    of their losses)."""
    labels = labels.long()
    valid = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    denom = valid.sum()
    scope = current_scope()
    if scope is not None and scope.dp_size > 1:
        from ...parallel.collectives import all_reduce_

        denom = all_reduce_(denom.clone(), scope.dp_group, "loss_count")
        return (torch.where(valid, nll, torch.zeros_like(nll)).sum()
                / denom.clamp_min(1) * scope.dp_size)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() \
        / denom.clamp_min(1)


def _bert_pretrain_loss_pure(nsp_logits, mlm_logits, mlm_labels,
                             nsp_labels):
    """Masked-LM CE over the valid (>= 0) MLM labels plus the mean NSP
    NLL, both from f32 log-softmaxes; labels may be int or float."""
    mlm_loss = masked_token_ce(mlm_logits, mlm_labels)
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_nll = -torch.gather(nsp_logp, -1,
                            nsp_labels.long()[:, None])[:, 0]
    return mlm_loss + nsp_nll.mean()


class BERTPretrainLoss(HybridBlock):
    """MLM + NSP loss over ``BERTModel`` outputs: ``outputs`` is (seq,
    pooled, nsp_logits, mlm_logits), ``labels`` is (mlm_labels (B, T) with
    -1 at unmasked positions, nsp_labels (B,)).  A 0-dim f32 loss."""

    def hybrid_forward(self, F, outputs, labels):
        _seq, _pooled, nsp_logits, mlm_logits = outputs
        mlm_labels, nsp_labels = labels
        return _bert_pretrain_loss_pure(nsp_logits, mlm_logits, mlm_labels,
                                        nsp_labels)


class BERTEmbedding(_ZooModel):
    """Token + type + position embedding front (the pipeline prologue):
    the token-type table holds segment 0 only, an additive (1, units)
    bias."""

    def __init__(self, vocab_size=30522, units=768, max_length=512,
                 dropout=0.0, device=None, **kwargs):
        super().__init__(**kwargs)
        self._dropout = dropout
        with self.name_scope():
            self.word_embed_weight = self.params.get(
                "word_embed_weight", shape=(vocab_size, units),
                init="normal")
            self.token_type_embed_weight = self.params.get(
                "token_type_embed_weight", shape=(1, units),
                init="normal")
            self.position_embed_weight = self.params.get(
                "position_embed_weight", shape=(max_length, units),
                init="normal")
            self.embed_ln = nn.LayerNorm(in_channels=units)
            if dropout:
                self.embed_drop = nn.Dropout(dropout)
        self._build_init(device)

    def hybrid_forward(self, F, inputs, word_embed_weight=None,
                       token_type_embed_weight=None,
                       position_embed_weight=None):
        T = inputs.shape[1]
        x = F.Embedding(inputs, word_embed_weight)
        x = x + token_type_embed_weight[0:1]
        x = x + position_embed_weight[:T]
        x = self.embed_ln(x)
        if self._dropout:
            x = self.embed_drop(x)
        return x


class BERTMLMHead(_ZooModel):
    """Transform + decode-to-vocab head (the pipeline epilogue), with its
    own, untied decode weight."""

    def __init__(self, vocab_size=30522, units=768, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.transform = nn.Dense(units, activation="gelu",
                                      in_units=units, flatten=False,
                                      prefix="transform_")
            self.ln = nn.LayerNorm(in_channels=units)
            self.decoder = nn.Dense(vocab_size, in_units=units,
                                    flatten=False, prefix="decoder_")
        self._build_init(device)

    def hybrid_forward(self, F, x):
        return self.decoder(self.ln(self.transform(x)))


class BERTMLMLoss(HybridBlock):
    """Masked-LM cross entropy over head logits; labels (B, T), -1 at
    unmasked positions."""

    def hybrid_forward(self, F, logits, labels):
        return masked_token_ce(logits, labels)


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
