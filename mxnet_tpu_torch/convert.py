"""Carry a model's weights from the JAX package into the port.

The loaders take numpy arrays only (the port never imports JAX), check
every entry before copying any, and raise on a missing, duplicate or
mis-shaped entry, so a model is never left half loaded.

- ``load_gluon_params`` takes the flat ``{name: np.ndarray}`` of a JAX
  Gluon block's ``collect_params()`` (BERT, GPT, ViT, ResNet ...) for the
  port's block of the same structure, by Gluon name: both packages name
  parameters alike (``bertmodel0_enc_layer0_qkv_weight``), less the
  top-level prefix, whose counter is per process.
- ``relayout`` turns such a dict between the per-layer trunk's names
  (``enc_layer{i}_qkv_weight``, ``enc_layernorm0_gamma``) and the scanned
  trunk's stacks (``enc_qkv_stack_weight``, ``enc_lnf_gamma``), so a
  model of either layout loads into the port's of the other;
  ``load_bert_params`` does that for a ``BERTModel``.
- ``load_transformer_params`` does the same for an encoder-decoder
  ``Transformer``: the ``enc_`` and ``dec_`` stacks (a decoder layer's
  self- and cross-attention packed ``qkv`` and ``proj``, its three
  LayerNorms), ``out_`` and the three embedding tables, by name.
- ``load_module_params`` takes a JAX ``Module``'s ``get_params()`` as
  numpy (parameters and auxiliary states) for a bound port ``Module``
  over the same symbol, by name.
- ``load_state`` takes the flat serving checkpoint that
  ``serving.state_for_serving`` writes (a scanned-trunk model's), and
  matches names by suffix (``*_stack_*``, ``lnf_*``, the two embeddings)
  as the JAX engine's ``_stacks_from_state`` does; ``load_stacks`` takes
  the numpy form of what ``gpt.extract_decoder_stacks`` returns.  Both
  load a ``GPTModel`` of either trunk layout.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .gluon.model_zoo.gpt import STACK_NAMES, trunk_parameters


#: what a serving checkpoint must hold, each matched by name suffix
STATE_SUFFIXES = STACK_NAMES + ("lnf_gamma", "lnf_beta", "tok_embed_weight",
                                "pos_embed_weight")


def as_tensor(arr, name, what):
    """A float32 host tensor holding a copy of a numpy array (float32
    first: numpy has no native bfloat16 for torch to take)."""
    _check_array(arr, name, what)
    return torch.from_numpy(np.array(arr, np.float32))


def _check_array(arr, name, what):
    if not isinstance(arr, np.ndarray):
        raise TypeError(f"{what}: {name!r} is a {type(arr).__name__}, "
                        f"expected a numpy array")


def _assign(model, arrays, what):
    """Copy ``arrays[name]`` (each of ``STATE_SUFFIXES``) into a GPT of
    either layout after checking every shape: a per-layer trunk takes
    slice i of a stack into layer i."""
    from .gluon.model_zoo.bert import ScanTransformerEncoder

    layered = not isinstance(model.encoder, ScanTransformerEncoder)
    targets = trunk_parameters(model)
    tensors = {}
    for name, ps in targets.items():
        t = tensors[name] = as_tensor(arrays[name], name, what)
        want = tuple(ps[0].shape)
        if layered and name in STACK_NAMES:
            want = (len(ps),) + want
        if tuple(t.shape) != want:
            raise MXNetError(f"{what}: {name!r} has shape {tuple(t.shape)}, "
                             f"the model wants {want}")
    for name, ps in targets.items():
        rows = tensors[name] if layered and name in STACK_NAMES \
            else [tensors[name]]
        for p, row in zip(ps, rows):
            p.set_data(row)


def match_state(state, what):
    """``{suffix: array}`` for each of ``STATE_SUFFIXES``, from a flat
    serving checkpoint; exactly one entry must end with each suffix."""
    arrays = {}
    for suffix in STATE_SUFFIXES:
        keys = [k for k in state if k.endswith(suffix)]
        if not keys:
            raise MXNetError(
                f"{what}: no entry ending {suffix!r}; a per-layer "
                f"(scan_layers=False) model's weights load through "
                f"load_stacks or load_gluon_params")
        if len(keys) > 1:
            raise MXNetError(f"{what}: {len(keys)} entries end "
                             f"{suffix!r}: {sorted(keys)}")
        arrays[suffix] = state[keys[0]]
    return arrays


def load_state(model, state):
    """Load a scanned-trunk serving checkpoint ``{name: np.ndarray}`` into
    a port ``GPTModel`` of either layout.  Entries are matched by name
    suffix; extra entries are ignored."""
    _assign(model, match_state(state, "load_state"), "load_state")


def load_stacks(model, stacks, lnf, tok, pos):
    """Load ``extract_decoder_stacks`` output in numpy form: ``stacks``
    maps each of ``STACK_NAMES`` to an (L, ...) array, ``lnf`` is
    ``(gamma, beta)``, ``tok``/``pos`` the embedding tables."""
    missing = [n for n in STACK_NAMES if n not in stacks]
    unknown = sorted(set(stacks) - set(STACK_NAMES))
    if missing or unknown:
        raise MXNetError(f"load_stacks: missing stacks {missing}, unknown "
                         f"stacks {unknown}")
    if len(lnf) != 2:
        raise MXNetError("load_stacks: lnf must be (gamma, beta)")
    arrays = dict(stacks, lnf_gamma=lnf[0], lnf_beta=lnf[1],
                  tok_embed_weight=tok, pos_embed_weight=pos)
    _assign(model, arrays, "load_stacks")


#: a per-layer layer's parameter names -> the scanned trunk's stack names
LAYER_TO_STACK = {
    "qkv_weight": "qkv_stack_weight", "qkv_bias": "qkv_stack_bias",
    "proj_weight": "proj_stack_weight", "proj_bias": "proj_stack_bias",
    "ffn1_weight": "ffn1_stack_weight", "ffn1_bias": "ffn1_stack_bias",
    "ffn2_weight": "ffn2_stack_weight", "ffn2_bias": "ffn2_stack_bias",
    "layernorm0_gamma": "ln1_stack_gamma", "layernorm0_beta": "ln1_stack_beta",
    "layernorm1_gamma": "ln2_stack_gamma", "layernorm1_beta": "ln2_stack_beta",
}
_STACK_TO_LAYER = {v: k for k, v in LAYER_TO_STACK.items()}
_LAYER_KEY = re.compile(r"^(.*)layer(\d+)_(" + "|".join(LAYER_TO_STACK) +
                        r")$")


def relayout(params, stacked):
    """``params`` (a Gluon ``{name: np.ndarray}``) with its transformer
    trunks in the scanned layout (``stacked``: ``{t}layer{i}_qkv_weight``
    stacked into ``{t}qkv_stack_weight``, ``{t}layernorm0_*`` becoming
    ``{t}lnf_*``) or the per-layer one (the reverse).  Entries of a trunk
    already in that layout, and every other entry, pass through."""
    out = {}
    if stacked:
        layers = {}
        for k, v in params.items():
            m = _LAYER_KEY.match(k)
            if m:
                layers.setdefault((m.group(1), m.group(3)), {})[
                    int(m.group(2))] = v
            else:
                out[k] = v
        trunks = {t for t, _ in layers}
        for (t, name), rows in layers.items():
            if sorted(rows) != list(range(len(rows))):
                raise MXNetError(f"relayout: {t}layer*_{name} has layers "
                                 f"{sorted(rows)}")
            out[t + LAYER_TO_STACK[name]] = np.stack(
                [rows[i] for i in range(len(rows))])
        for t in trunks:
            for part in ("gamma", "beta"):
                if t + "layernorm0_" + part in out:
                    out[t + "lnf_" + part] = out.pop(t + "layernorm0_" + part)
        return out
    for k, v in params.items():
        stack = next((s for s in _STACK_TO_LAYER if k.endswith(s)), None)
        if stack is not None:
            t = k[:-len(stack)]
            for i, row in enumerate(v):
                out[f"{t}layer{i}_{_STACK_TO_LAYER[stack]}"] = row
        elif k.endswith(("lnf_gamma", "lnf_beta")):
            part = k.rsplit("_", 1)[1]
            out[k[:-len("lnf_" + part)] + "layernorm0_" + part] = v
        else:
            out[k] = v
    return out


def load_bert_params(model, params):
    """Load a JAX ``BERTModel``'s ``{name: np.ndarray}`` (its
    ``collect_params()`` as numpy, either trunk layout) into a port
    ``BERTModel`` of either layout: ``relayout`` to the port's, then
    ``load_gluon_params``.  Exactly one entry may end
    ``word_embed_weight``."""
    from .gluon.model_zoo.bert import ScanTransformerEncoder

    roots = [k for k in params if k.endswith("word_embed_weight")]
    if len(roots) != 1:
        raise MXNetError(f"load_bert_params: want one entry ending "
                         f"'word_embed_weight', found {sorted(roots)}")
    load_gluon_params(model, relayout(
        params, isinstance(model.encoder, ScanTransformerEncoder)))


def load_transformer_params(model, params):
    """Load a JAX ``Transformer``'s ``{name: np.ndarray}`` (its
    ``collect_params()`` as numpy) into a port ``Transformer`` of the same
    configuration through ``load_gluon_params``.  Exactly one entry may
    end ``src_embed_weight``."""
    roots = [k for k in params if k.endswith("src_embed_weight")]
    if len(roots) != 1:
        raise MXNetError(f"load_transformer_params: want one entry ending "
                         f"'src_embed_weight', found {sorted(roots)}")
    load_gluon_params(model, params)


def _dtype_name(arr):
    return np.dtype(arr.dtype).name


def load_gluon_params(block, params):
    """Load ``{name: np.ndarray}`` (a JAX Gluon block's
    ``collect_params()`` as numpy) into the port's ``block`` of the same
    structure, aux state (BatchNorm's running statistics) included.  Names
    are compared with each side's top-level prefix stripped, since the
    name counters are per process (``resnetv10_`` against
    ``resnetv11_``): the JAX prefix is the one under which every port
    name has an entry.  Each entry must match its parameter's shape and
    dtype (bfloat16 arrays come as ``ml_dtypes.bfloat16``); a deferred
    parameter takes the entry as its value.  Raises on a missing,
    mis-shaped, mis-typed or unused entry before copying anything."""
    what = "load_gluon_params"
    ports = {p.name[len(block.prefix):]: p
             for p in block.collect_params().values()}
    if not ports:
        if params:
            raise MXNetError(f"{what}: the port block has no parameters, "
                             f"given {sorted(params)}")
        return
    prefixes = {k[:-len(s)] for k in params for s in ports if k.endswith(s)}
    found = [pre for pre in prefixes
             if all(pre + s in params for s in ports)]
    if len(found) != 1:
        missing = sorted(s for s in ports
                         if not any(k.endswith(s) for k in params))
        raise MXNetError(f"{what}: no single prefix under which every "
                         f"parameter has an entry (candidates {sorted(found)}"
                         f"; names with no entry {missing[:8]})")
    prefix = found[0]
    unused = sorted(k for k in params
                    if k.startswith(prefix) and k[len(prefix):] not in ports)
    if unused:
        raise MXNetError(f"{what}: entries the port block has no parameter "
                         f"for: {unused}")
    for short, p in ports.items():
        arr = params[prefix + short]
        _check_array(arr, prefix + short, what)
        if p.shape is not None and (len(p.shape) != arr.ndim or any(
                d not in (0, a) for d, a in zip(p.shape, arr.shape))):
            raise MXNetError(f"{what}: {prefix + short!r} has shape "
                             f"{arr.shape}, the block wants {p.shape}")
        want = str(torch_dtype(p.dtype)).split(".")[-1]
        if _dtype_name(arr) != want:
            raise MXNetError(f"{what}: {prefix + short!r} is "
                             f"{_dtype_name(arr)}, the block holds {want}")
    for short, p in ports.items():
        arr = params[prefix + short]
        t = torch.from_numpy(np.array(arr, np.float32))
        if p._tensor is None:
            p._init_impl(t)
            p._shape = tuple(arr.shape)
        else:
            p.set_data(t)


def load_module_params(module, arg_params, aux_params=None):
    """Load ``{name: np.ndarray}`` parameters and auxiliary states (a JAX
    ``Module``'s ``get_params()`` as numpy) into a bound port ``Module``,
    by name, each cast to the bound array's dtype.  Raises on a missing,
    mis-shaped or unused entry before copying anything."""
    what = "load_module_params"
    if not module.binded:
        raise MXNetError(f"{what}: bind the module first")
    exe = module._exec
    aux_params = aux_params or {}
    for given, names, table, kind in (
            (arg_params, module._param_names, exe.arg_dict, "parameter"),
            (aux_params, module._aux_names, exe.aux_dict,
             "auxiliary state")):
        missing = sorted(set(names) - set(given))
        unused = sorted(set(given) - set(names))
        if missing or unused:
            raise MXNetError(f"{what}: {kind}s missing {missing}, entries "
                             f"the module has no {kind} for {unused}")
        for name in names:
            _check_array(given[name], name, what)
            if tuple(given[name].shape) != tuple(table[name].shape):
                raise MXNetError(
                    f"{what}: {name!r} has shape {given[name].shape}, the "
                    f"module binds {tuple(table[name].shape)}")
    exe.copy_params_from(
        {k: as_tensor(v, k, what) for k, v in arg_params.items()},
        {k: as_tensor(v, k, what) for k, v in aux_params.items()})
    module.params_initialized = True
