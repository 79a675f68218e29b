"""Decoder-only (GPT-style) language model, its LM loss and its
full-recompute decode, as Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py``: ``GPTModel`` (token +
position embedding, causal pre-LN trunk, LM head tied to the token
embedding; ``scan_layers`` picks the stacked ``ScanTransformerEncoder``,
with LoRA stacks and per-layer remat, over the per-layer
``TransformerEncoder``, both ``trunk_``), ``GPTLMLoss``, the
``gpt2_small``/``gpt2_medium``/``gpt_tiny`` configs, ``STACK_NAMES``,
``extract_decoder_stacks`` (either layout as (L, ...) stacks, for the
serving engine and the cached decoder), the pipeline parts'
``GPTEmbedding``/``GPTHead``, ``generate`` with its helpers
``_windowed_last_logits`` and ``_sample``, the KV-cache
``CachedDecoder``, ``speculative_decode`` and ``beam_generate``.
With ``attention_impl="flash"`` the trunk runs the hand-written
flash-attention kernels on a CUDA device, forward and backward.

The cached decoders (``CachedDecoder`` here, ``serving.ServingEngine``)
share one block step, ``decoder_step``, over the weights
``decoder_weights`` lays out head-major; the JAX package has one copy of
that step in each.  It is the reference's XLA code in PyTorch: dense
attention over the cache window with a per-row causal mask, no kernel of
the port's own.  ``CachedDecoder(mesh=...)`` (tensor-parallel decoding)
waits for several cards, ROADMAP queue 1 item 6, and raises.

Dropout follows ``autograd.is_training()`` (the trainers open training
mode), its masks drawn from ``random.current_generator``.  A model is
built initialised on ``device`` (default the card) with N(0, 0.02)
weights, zero biases and unit LayerNorm scales (``bert._ZooModel``).
``gpt_pipeline_parts`` comes with the pipeline slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import initializer as _init
from ...base import MXNetError, torch_dtype
from ...ndarray.ndarray import NDArray
from ...ops.nn import activation, layer_norm
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


def _ids_tensor(ids, device):
    """(B, T) token ids (an NDArray, tensor or array) as int64 on
    ``device``."""
    raw = ids._data if isinstance(ids, NDArray) else ids
    return torch.as_tensor(raw, device=device).long()


def _tokens_nd(tokens, device):
    """Token rows as the float32 ``NDArray`` the decoders return."""
    from ... import context

    return NDArray(torch.as_tensor(tokens, device=device).float(),
                   context.context_of(device))


def generate(model, ids, max_new_tokens=16, temperature=None,
             generator=None):
    """Greedy (or sampled) decode by full recompute per step; ids: (B, T0)
    seed tokens (an NDArray, tensor or array).  Returns the (B, T0 +
    max_new_tokens) tokens as a float32 ``NDArray`` on the model's device,
    as the JAX package's ``generate``.

    Every step runs the whole trunk over the right-padded max_length
    window, so with ``attention_impl="flash"`` each new token launches
    the flash kernel once per layer."""
    device = _model_device(model)
    out = _ids_tensor(ids, device)
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            nxt = _sample(_windowed_last_logits(model, out), temperature,
                          generator)
            out = torch.cat([out, nxt[:, None]], dim=1)
    return _tokens_nd(out, device)


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


# -- the cached decoders ---------------------------------------------------------

_NEG = -1e30
#: the big tensors a serving dtype applies to
_MATRICES = ("qkv_stack_weight", "proj_stack_weight", "ffn1_stack_weight",
             "ffn2_stack_weight")


def decoder_weights(stacks, lnf, tok, pos, heads, device, dtype=None):
    """The cached decoders' copy of a GPT's weights on ``device``,
    head-major: qkv as (L, 3, H, Dh, C), the projection as (L, C, H, Dh).
    With ``dtype`` (bf16) the four matrix stacks and the two embedding
    tables take it; LayerNorm, biases and every reduction stay f32."""
    L, C = stacks["qkv_stack_weight"].shape[0], tok.shape[1]
    Dh = C // heads

    def put(t, big=False):
        dt = dtype if big and dtype is not None else torch.float32
        return t.to(device=device, dtype=dt, copy=True)

    s = {n: put(t, n in _MATRICES) for n, t in stacks.items()}
    return {
        "tok": put(tok, True), "pos": put(pos, True),
        "qkv": s["qkv_stack_weight"].reshape(L, 3, heads, Dh, C),
        "qkv_b": s["qkv_stack_bias"].reshape(L, 3, heads, Dh),
        "proj": s["proj_stack_weight"].reshape(L, C, heads, Dh),
        "proj_b": s["proj_stack_bias"],
        "ffn1": s["ffn1_stack_weight"], "ffn1_b": s["ffn1_stack_bias"],
        "ffn2": s["ffn2_stack_weight"], "ffn2_b": s["ffn2_stack_bias"],
        "ln1_g": s["ln1_stack_gamma"], "ln1_b": s["ln1_stack_beta"],
        "ln2_g": s["ln2_stack_gamma"], "ln2_b": s["ln2_stack_beta"],
        "lnf_g": put(lnf[0]), "lnf_b": put(lnf[1]),
    }


def decoder_step(w, ck, cv, pos, toks, act, last=None):
    """One block step of the cached decoders over ``decoder_weights``
    ``w``: toks (B, S) int64 at per-row offsets pos (B,).  Writes the S new
    keys and values into ck/cv (L, B, H, W, Dh) in place at slots pos[b]
    .. pos[b] + S - 1, and position s of row b attends the slots <=
    pos[b] + s (stale slots beyond are masked, and each is overwritten
    before it is attended).  Returns the logits (B, S, vocab) f32, or
    with ``last`` (B,) only each row's at position last[b], (B, vocab).
    Every op is row-independent, so pad rows never leak into real rows."""
    B, S = toks.shape
    L, _, _, W, Dh = ck.shape
    dev = toks.device
    positions = pos[:, None] + torch.arange(S, device=dev)    # (B, S)
    rows = torch.arange(B, device=dev)[:, None]
    keep = torch.arange(W, device=dev)[None, None, :] \
        <= positions[:, :, None]                               # (B, S, W)
    x = (w["tok"][toks] + w["pos"][positions]).float()        # (B, S, C)
    for i in range(L):
        h = layer_norm(x, w["ln1_g"][i], w["ln1_b"][i])
        qkv = torch.einsum("bsc,thdc->bsthd", h, w["qkv"][i].float()) \
            + w["qkv_b"][i]
        qh, kh, vh = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        ck_l, cv_l = ck[i], cv[i]                              # (B,H,W,Dh)
        ck_l.transpose(1, 2)[rows, positions] = \
            kh.transpose(1, 2).to(ck_l.dtype)
        cv_l.transpose(1, 2)[rows, positions] = \
            vh.transpose(1, 2).to(cv_l.dtype)
        scores = torch.einsum("bhsd,bhwd->bhsw", qh, ck_l.float()) \
            * (Dh ** -0.5)
        scores = scores.masked_fill(~keep[:, None], _NEG)
        p = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhsw,bhwd->bhsd", p, cv_l.float())
        attn = torch.einsum("bhsd,chd->bsc", attn, w["proj"][i].float()) \
            + w["proj_b"][i]
        x = x + attn
        h = layer_norm(x, w["ln2_g"][i], w["ln2_b"][i])
        h = torch.matmul(h, w["ffn1"][i].float().t()) + w["ffn1_b"][i]
        h = activation(h, act)
        x = x + (torch.matmul(h, w["ffn2"][i].float().t())
                 + w["ffn2_b"][i])
    if last is not None:
        x = x[rows[:, 0], last]                                # (B, C)
    h = layer_norm(x, w["lnf_g"], w["lnf_b"])
    return torch.matmul(h, w["tok"].float().t())


def _prefill_bucket(n, window):
    """The power-of-two prefill length (at least 8, at most the window)
    that a seed of ``n`` tokens is right-padded to."""
    b = 8
    while b < n:
        b *= 2
    return min(b, window)


class CachedDecoder:
    """A GPTModel's KV-cache decoder on the model's device: the (L, ...)
    stacks pulled once (either trunk layout), a chunked prefill of the
    seed, then one S=1 block step a token.  ``decode`` has ``generate``'s
    sampling surface.  ``dtype`` (``"bfloat16"`` or a torch dtype) puts
    the matrix stacks, the embedding tables and the cache in it, the
    accumulation and the residual stream in f32.  ``mesh``
    (tensor-parallel decoding) waits for the next multi-GPU slice: a
    mesh raises."""

    def __init__(self, model, mesh=None, dtype=None):
        if mesh is not None:
            raise MXNetError(
                "CachedDecoder(mesh=...): tensor-parallel decoding waits "
                "for the next multi-GPU slice (ROADMAP queue 1 item 1b); "
                "decode on one device without mesh=")
        stacks, lnf, tok, pos, heads, act = extract_decoder_stacks(model)
        self._W = model._max_length
        self._act = act
        self._device = _model_device(model)
        self._dtype = None if dtype is None else torch_dtype(dtype)
        self._w = decoder_weights(stacks, lnf, tok, pos, heads,
                                  self._device, self._dtype)
        self._vocab = tok.shape[0]

    def _init_cache(self, B):
        """Fresh zeroed (ck, cv) for batch B: (L, B, H, W, Dh) in the
        embedding tables' dtype."""
        L, _, H, Dh, _ = self._w["qkv"].shape
        shape = (L, B, H, self._W, Dh)
        dt = self._w["tok"].dtype
        return (torch.zeros(shape, dtype=dt, device=self._device),
                torch.zeros(shape, dtype=dt, device=self._device))

    def _step(self, ck, cv, pos, toks):
        """The block step with every row at write offset ``pos`` (an int):
        toks (B, S) int64 on the device; ck/cv written in place.  Returns
        the logits (B, S, vocab)."""
        p = torch.full((toks.shape[0],), pos, dtype=torch.int64,
                       device=self._device)
        return decoder_step(self._w, ck, cv, p, toks, self._act)

    def decode(self, ids, max_new_tokens=16, temperature=None,
               generator=None, return_logits=False):
        """ids: (B, T0) seed; returns the (B, T0 + N) tokens as a float32
        NDArray, as ``generate`` does, at O(W) a new token.  T0 +
        max_new_tokens must fit the window max_length.  The seed is
        right-padded to a power-of-two bucket for its one prefill step
        (the pad's cache writes are overwritten before they are attended).
        With ``return_logits=True`` also returns the (N, B, vocab)
        pre-sampling logits as a numpy array."""
        out = _ids_tensor(ids, self._device)
        B, T0 = out.shape
        if T0 + max_new_tokens > self._W:
            raise ValueError(
                f"decode: {T0} seed + {max_new_tokens} new tokens "
                f"exceed the cache window max_length={self._W}; use "
                "generate() for sliding-window decoding")
        lg, toks = [], [out]
        with torch.no_grad():
            ck, cv = self._init_cache(B)
            padded = out.new_zeros((B, _prefill_bucket(T0, self._W)))
            padded[:, :T0] = out
            logits = self._step(ck, cv, 0, padded)[:, T0 - 1]
            for n in range(max_new_tokens):
                lg.append(logits)
                nxt = _sample(logits, temperature, generator)
                toks.append(nxt[:, None])
                if n < max_new_tokens - 1:    # the last token needs no step
                    logits = self._step(ck, cv, T0 + n, nxt[:, None])[:, -1]
        result = _tokens_nd(torch.cat(toks, dim=1), self._device)
        if return_logits:
            stacked = (torch.stack(lg).cpu().numpy() if lg else
                       np.zeros((0, B, self._vocab), np.float32))
            return result, stacked
        return result


def speculative_decode(target, draft, ids, max_new_tokens=16, k=4,
                       return_stats=False):
    """Greedy speculative decoding, lossless: the tokens
    ``CachedDecoder(target).decode`` emits greedily, up to rounding ties.

    The ``draft`` proposes ``k`` tokens with k S=1 steps; the ``target``
    verifies them in one (k+1)-token block step, accepting the longest
    prefix where its own greedy choice agrees, plus its own token at the
    first disagreement (or a bonus token when all agree).  Rows advance
    together at the smallest acceptance of the batch.  target/draft:
    GPTModel or CachedDecoder.  Returns (B, T0 + N) tokens as a float32
    NDArray; with ``return_stats=True`` also rounds and accepted counts.

    "Lossless" holds up to f32 rounding ties: the S=k+1 verify step may
    reduce in another order than decode()'s S=1 step, so an argmax
    inside rounding noise can flip."""
    tgt = target if isinstance(target, CachedDecoder) \
        else CachedDecoder(target)
    drf = draft if isinstance(draft, CachedDecoder) \
        else CachedDecoder(draft)
    dev = tgt._device
    out = _ids_tensor(ids, dev).cpu().numpy()
    B, T0 = out.shape
    total = T0 + max_new_tokens
    if total + k > min(tgt._W, drf._W):
        raise ValueError(
            f"speculative_decode: {total} tokens + {k} draft overshoot "
            f"exceed cache window (target {tgt._W}, draft {drf._W})")

    def run(dec, cache, pos, block):
        return dec._step(*cache, pos, torch.as_tensor(
            np.ascontiguousarray(block), device=dec._device))

    with torch.no_grad():
        t_cache, d_cache = tgt._init_cache(B), drf._init_cache(B)
        # both caches take the seed less its last token: the cache holds
        # positions < P-1, and the last committed token heads each block
        if T0 > 1:
            padded = np.zeros((B, _prefill_bucket(
                T0 - 1, min(tgt._W, drf._W))), np.int64)
            padded[:, :T0 - 1] = out[:, :-1]
            run(tgt, t_cache, 0, padded)
            run(drf, d_cache, 0, padded)
        P, dp = T0, T0 - 1     # dp: the next draft-cache slot to write
        rounds = accepted_total = 0
        while P < total:
            # after a full accept the bonus token advanced P past what the
            # proposals wrote: feed the draft the committed tokens it lacks
            while dp < P - 1:
                run(drf, d_cache, dp, out[:, dp][:, None])
                dp += 1
            props = np.zeros((B, k), np.int64)
            last = out[:, P - 1]
            for j in range(k):
                d_lg = run(drf, d_cache, P - 1 + j, last[:, None])
                last = d_lg[:, -1].argmax(dim=-1).cpu().numpy()
                props[:, j] = last
            dp = P - 1 + k
            # the target's greedy pick for positions P .. P+k, in one step
            block = np.concatenate([out[:, P - 1:P], props], axis=1)
            choice = run(tgt, t_cache, P - 1, block).argmax(dim=-1) \
                .cpu().numpy()                                  # (B, k+1)
            agree = props == choice[:, :k]
            full = agree.all(axis=1)
            m = int(np.where(full, k, np.argmin(agree, axis=1)).min())
            commit = np.concatenate([props[:, :m], choice[:, m:m + 1]],
                                    axis=1)[:, :total - P]
            out = np.concatenate([out, commit], axis=1)
            P += commit.shape[1]
            rounds += 1
            accepted_total += min(m, commit.shape[1])
    toks = _tokens_nd(out, dev)
    if return_stats:
        return toks, {"rounds": rounds, "proposed_per_round": k,
                      "accepted_draft_tokens": accepted_total,
                      "new_tokens": max_new_tokens}
    return toks


def beam_generate(model, ids, max_new_tokens=16, beam_size=4, eos_id=None,
                  alpha=0.6):
    """Beam-search continuation of a shared prompt (the decoder-only
    analog of ``transformer.beam_search``: the same host ``beam_loop``
    and GNMT length penalty), each hypothesis scored by a full window
    forward.  ids: (B, T0) seed; returns (tokens (B, T0 + N) as a float32
    NDArray, scores (B,) numpy)."""
    from ... import autograd
    from .transformer import beam_loop

    dev = _model_device(model)
    seed = _ids_tensor(ids, dev).cpu().numpy()

    def score_last(flat):
        with autograd.predict_mode(), torch.no_grad():
            last = _windowed_last_logits(model, torch.as_tensor(flat,
                                                                device=dev))
        return last.float().cpu().numpy()

    out, scores = beam_loop(score_last, seed.shape[0], beam_size, None,
                            eos_id, max_new_tokens, alpha, seed_beams=seed)
    return _tokens_nd(out, dev), scores
