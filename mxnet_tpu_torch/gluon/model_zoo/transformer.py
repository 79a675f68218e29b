"""Encoder-decoder Transformer (the NMT family), as Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py``, block for
block and name for name: ``TransformerDecoderLayer`` (pre-LN: causal
self-attention, cross-attention over the encoder's memory, FFN),
``TransformerDecoder``, ``Transformer`` (the encoder is
``bert.TransformerEncoder``, ``enc_``; the decoder ``dec_``; the output
projection ``out_``) with ``greedy_decode``, ``LabelSmoothedCELoss``,
``transformer_base`` (the base model of "Attention Is All You Need") and
``transformer_tiny``, and the host-side beam search: ``beam_loop`` (the
numpy core ``gpt.beam_generate`` shares), ``beam_search`` and
``_logsumexp``.  Weights carry across from the JAX package by name
(``convert.load_transformer_params``).

Self-attention in both stacks runs ``attention_impl``: with ``"flash"``
on a CUDA device the encoder runs the hand-written flash kernels
non-causal and the decoder causal, forward and backward (on the CPU they
take their plain path).  Cross-attention stays dense, as in the
reference.  ``"ring"`` and ``"ulysses"`` (sequence parallelism) dispatch
through the attention op to ``parallel.ring`` inside a sharded step with
an sp axis, on the same flash kernels.

``greedy_decode`` and ``beam_search`` grow the target one token a step and
rerun the whole model each step, as the reference's host loops do; a model
is built initialised on ``device`` (default the card) with ``Xavier()``
over each parameter's own init, as the zoo's other models
(``bert._ZooModel``).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import autograd
from ..block import HybridBlock
from .. import nn
from .bert import TransformerEncoder, _ZooModel
from .gpt import _ids_tensor


class TransformerDecoderLayer(HybridBlock):
    """Pre-LN decoder layer: causal self-attn -> cross-attn -> FFN."""

    def __init__(self, units, num_heads, hidden_size=None, dropout=0.1,
                 attention_impl="dense", activation="relu", **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        hidden_size = hidden_size or 4 * units
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        self._attention_impl = attention_impl
        self._activation = activation
        with self.name_scope():
            self.self_qkv_weight = self.params.get(
                "self_qkv_weight", shape=(3 * units, units))
            self.self_qkv_bias = self.params.get(
                "self_qkv_bias", shape=(3 * units,), init="zeros")
            self.self_proj_weight = self.params.get(
                "self_proj_weight", shape=(units, units))
            self.self_proj_bias = self.params.get(
                "self_proj_bias", shape=(units,), init="zeros")
            self.cross_qkv_weight = self.params.get(
                "cross_qkv_weight", shape=(3 * units, units))
            self.cross_qkv_bias = self.params.get(
                "cross_qkv_bias", shape=(3 * units,), init="zeros")
            self.cross_proj_weight = self.params.get(
                "cross_proj_weight", shape=(units, units))
            self.cross_proj_bias = self.params.get(
                "cross_proj_bias", shape=(units,), init="zeros")
            self.ffn1_weight = self.params.get(
                "ffn1_weight", shape=(hidden_size, units))
            self.ffn1_bias = self.params.get(
                "ffn1_bias", shape=(hidden_size,), init="zeros")
            self.ffn2_weight = self.params.get(
                "ffn2_weight", shape=(units, hidden_size))
            self.ffn2_bias = self.params.get(
                "ffn2_bias", shape=(units,), init="zeros")
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ln2 = nn.LayerNorm(in_channels=units)
            self.ln3 = nn.LayerNorm(in_channels=units)
            if dropout:
                self.drop = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, memory, self_qkv_weight,
                       self_qkv_bias, self_proj_weight, self_proj_bias,
                       cross_qkv_weight, cross_qkv_bias,
                       cross_proj_weight, cross_proj_bias, ffn1_weight,
                       ffn1_bias, ffn2_weight, ffn2_bias):
        h = self.ln1(x)
        attn = F.multi_head_attention(
            h, h, h, qkv_weight=self_qkv_weight,
            qkv_bias=self_qkv_bias, proj_weight=self_proj_weight,
            proj_bias=self_proj_bias, num_heads=self._num_heads,
            causal=True, impl=self._attention_impl)
        if self._dropout:
            attn = self.drop(attn)
        x = x + attn
        h = self.ln2(x)
        cross = F.multi_head_attention(
            h, memory, memory, qkv_weight=cross_qkv_weight,
            qkv_bias=cross_qkv_bias, proj_weight=cross_proj_weight,
            proj_bias=cross_proj_bias, num_heads=self._num_heads,
            impl="dense")
        if self._dropout:
            cross = self.drop(cross)
        x = x + cross
        h = self.ln3(x)
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


class TransformerDecoder(HybridBlock):
    """``num_layers`` ``TransformerDecoderLayer``s (``layer{i}_``), each
    over the same encoder memory, and a final LayerNorm."""

    def __init__(self, num_layers, units, num_heads, hidden_size=None,
                 dropout=0.1, attention_impl="dense", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.layers = []
            for i in range(num_layers):
                layer = TransformerDecoderLayer(
                    units, num_heads, hidden_size, dropout,
                    attention_impl, prefix=f"layer{i}_")
                self.register_child(layer)
                self.layers.append(layer)
            self.ln_f = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, memory):
        for layer in self.layers:
            x = layer(x, memory)
        return self.ln_f(x)


class Transformer(_ZooModel):
    """Encoder-decoder Transformer for seq2seq (NMT).  Input (B, S) source
    and (B, T) target token ids; output (B, T, tgt_vocab) logits."""

    def __init__(self, src_vocab, tgt_vocab, units=512, num_layers=6,
                 num_heads=8, hidden_size=None, max_length=512,
                 dropout=0.1, attention_impl="dense", device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        with self.name_scope():
            self.src_embed_weight = self.params.get(
                "src_embed_weight", shape=(src_vocab, units),
                init="normal")
            self.tgt_embed_weight = self.params.get(
                "tgt_embed_weight", shape=(tgt_vocab, units),
                init="normal")
            self.position_embed_weight = self.params.get(
                "position_embed_weight", shape=(max_length, units),
                init="normal")
            self.encoder = TransformerEncoder(
                num_layers, units, num_heads, hidden_size, dropout,
                attention_impl, prefix="enc_")
            self.decoder = TransformerDecoder(
                num_layers, units, num_heads, hidden_size, dropout,
                attention_impl, prefix="dec_")
            self.out_proj = nn.Dense(tgt_vocab, in_units=units,
                                     flatten=False, prefix="out_")
        self._build_init(device)

    def hybrid_forward(self, F, src_tokens, tgt_tokens,
                       src_embed_weight, tgt_embed_weight,
                       position_embed_weight):
        scale = float(self._units) ** 0.5
        src = F.Embedding(src_tokens, src_embed_weight,
                          input_dim=src_embed_weight.shape[0],
                          output_dim=src_embed_weight.shape[1]) * scale
        tgt = F.Embedding(tgt_tokens, tgt_embed_weight,
                          input_dim=tgt_embed_weight.shape[0],
                          output_dim=tgt_embed_weight.shape[1]) * scale
        src = src + F.slice(position_embed_weight, begin=(0, 0),
                            end=(src.shape[-2], None))
        tgt = tgt + F.slice(position_embed_weight, begin=(0, 0),
                            end=(tgt.shape[-2], None))
        memory = self.encoder(src)
        dec = self.decoder(tgt, memory)
        return self.out_proj(dec)

    def _device(self):
        return self.src_embed_weight.data()._data.device

    def greedy_decode(self, src_tokens, bos_id, eos_id, max_len=64):
        """Host-driven greedy decoding (reference analog: sockeye's
        inference loop): the target grows from ``bos_id`` one argmax a
        step, each step one forward over the whole target; a row that
        emitted ``eos_id`` keeps emitting it.  Returns the (B, <=max_len)
        int32 tokens as a numpy array."""
        dev = self._device()
        src = _ids_tensor(src_tokens, dev)
        B = src.shape[0]
        tgt = np.full((B, 1), bos_id, np.int32)
        finished = np.zeros(B, bool)
        for _ in range(max_len - 1):
            with autograd.predict_mode(), torch.no_grad():
                logits = self(src, torch.as_tensor(tgt, device=dev).long())
            nxt = logits[:, -1].float().argmax(dim=-1).cpu().numpy() \
                .astype(np.int32)
            nxt = np.where(finished, eos_id, nxt)
            tgt = np.concatenate([tgt, nxt[:, None]], axis=1)
            finished |= nxt == eos_id
            if finished.all():
                break
        return tgt


class LabelSmoothedCELoss(HybridBlock):
    """Label-smoothed cross entropy (the NMT training loss; reference
    analog: sockeye/gluon-nlp label smoothing): (1 - eps) * NLL + eps *
    the mean of -log p over the vocabulary, from the f32 log-softmax,
    averaged over the labels != ``ignore_index`` (the denominator at
    least 1).  A 0-dim f32 loss."""

    def __init__(self, smoothing=0.1, ignore_index=-1, **kwargs):
        super().__init__(**kwargs)
        self._eps = smoothing
        self._ignore = ignore_index

    def hybrid_forward(self, F, logits, labels):
        labels = labels.long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        valid = labels != self._ignore
        safe = labels.clamp_min(0)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        smooth = -logp.mean(dim=-1)
        loss = (1.0 - self._eps) * nll + self._eps * smooth
        denom = valid.sum().clamp_min(1)
        return torch.where(valid, loss, torch.zeros_like(loss)).sum() \
            / denom


def transformer_base(src_vocab, tgt_vocab, **kwargs):
    """The 'base' configuration of the original paper: d_model 512, 6 + 6
    layers, 8 heads, d_ff 2048."""
    return Transformer(src_vocab, tgt_vocab, units=512, num_layers=6,
                       num_heads=8, hidden_size=2048, **kwargs)


def transformer_tiny(src_vocab, tgt_vocab, **kwargs):
    """Test-sized configuration."""
    return Transformer(src_vocab, tgt_vocab, units=32, num_layers=2,
                       num_heads=2, hidden_size=64, **kwargs)


def beam_loop(score_last_fn, B, beam_size, init_token, eos_id,
              max_steps, alpha=0.6, seed_beams=None):
    """Length-normalized beam search core (GNMT length penalty), on the
    host in numpy.

    ``score_last_fn(flat_tokens (B*K, T)) -> (B*K, V)`` returns the last
    position's logits of each hypothesis.  Seeds from a single
    ``init_token`` (encoder-decoder: BOS) or ``seed_beams`` (B, T0), a
    shared prompt a batch row (decoder-only LMs).  Returns (tokens (B, T),
    normalized scores (B,))."""
    K = beam_size
    if seed_beams is not None:
        beams = np.repeat(seed_beams[:, None, :], K, axis=1) \
            .astype(np.int32)
    else:
        beams = np.full((B, K, 1), init_token, np.int32)
    seed_len = beams.shape[2]
    scores = np.full((B, K), -1e9, np.float32)
    scores[:, 0] = 0.0  # only the first beam is live initially
    # a prompt already ending in EOS starts finished (free-EOS padding)
    finished = (beams[:, :, -1] == eos_id) if eos_id is not None \
        else np.zeros((B, K), bool)

    for _ in range(max_steps):
        flat = beams.reshape(B * K, -1)
        logp = score_last_fn(flat)
        logp = logp - _logsumexp(logp)  # normalize to log-probs
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        if eos_id is not None:
            # finished beams only extend with EOS at no cost
            logp = np.where(
                finished[:, :, None],
                np.where(np.arange(V)[None, None, :] == eos_id, 0.0,
                         -1e9),
                logp)
        total = scores[:, :, None] + logp               # (B, K, V)
        flat_total = total.reshape(B, K * V)
        top = np.argsort(-flat_total, axis=1)[:, :K]     # (B, K)
        new_scores = np.take_along_axis(flat_total, top, axis=1)
        src_beam = top // V
        tok = (top % V).astype(np.int32)
        beams = np.concatenate(
            [np.take_along_axis(beams, src_beam[:, :, None], axis=1),
             tok[:, :, None]], axis=2)
        if eos_id is not None:
            finished = np.take_along_axis(finished, src_beam, axis=1) \
                | (tok == eos_id)
        scores = new_scores
        if eos_id is not None and finished.all():
            break

    # GNMT length penalty on the final scores, over generated tokens only
    # (scores hold no seed-token log-probs)
    gen = beams[:, :, seed_len:]
    if eos_id is not None:
        lengths = (gen != eos_id).sum(axis=2).astype(np.float32)
    else:
        lengths = np.full((B, K), gen.shape[2], np.float32)
    lp = ((5.0 + lengths) / 6.0) ** alpha
    normed = scores / lp
    best = normed.argmax(axis=1)
    out = beams[np.arange(B), best]
    return out, normed[np.arange(B), best]


def beam_search(model, src_tokens, bos_id, eos_id, beam_size=4,
                max_len=64, alpha=0.6):
    """Length-normalized beam search (reference analog: sockeye's
    inference; length penalty ((5+|Y|)/6)^alpha from GNMT): the host
    ``beam_loop``, each scoring step one forward over the B*beam
    hypotheses in predict mode.  Returns (tokens (B, <=max_len) int32,
    scores (B,))."""
    dev = model._device()
    src = _ids_tensor(src_tokens, dev)
    B = src.shape[0]
    src_rep = src.repeat_interleave(beam_size, dim=0)   # (B*K, S)

    def score_last(flat):
        with autograd.predict_mode(), torch.no_grad():
            logits = model(src_rep, torch.as_tensor(flat, device=dev).long())
        return logits[:, -1].float().cpu().numpy()

    return beam_loop(score_last, B, beam_size, bos_id, eos_id,
                     max_len - 1, alpha)


def _logsumexp(a):
    m = a.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(a - m).sum(axis=-1, keepdims=True))
