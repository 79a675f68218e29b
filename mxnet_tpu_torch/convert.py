"""Carry a model's weights from the JAX package into the port.

The loaders take numpy arrays only (the port never imports JAX), check
every entry before copying any, and raise on a missing, duplicate or
mis-shaped entry, so a model is never left half loaded.

- ``load_state`` takes the flat ``{name: np.ndarray}`` serving checkpoint
  that ``mxnet_tpu.serving.state_for_serving`` writes for a scanned-trunk
  model, and matches names by suffix (``*_stack_*``, ``lnf_*``, the two
  embeddings) as the JAX engine's ``_stacks_from_state`` does.
- ``load_stacks`` takes the numpy form of what
  ``mxnet_tpu.gluon.model_zoo.gpt.extract_decoder_stacks`` returns, which
  covers the per-layer trunk too: its LayerNorm names (``layernorm0_...``)
  cannot be told apart by suffix.
- ``load_bert_params`` takes the flat ``{name: np.ndarray}`` of a JAX
  ``BERTModel``'s ``collect_params()``, either trunk layout.
- ``load_gluon_params`` takes the same of any JAX Gluon block (ResNet ...)
  for the port's block of the same structure, running statistics
  included.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .gluon.model_zoo.gpt import STACK_NAMES


#: what a serving checkpoint must hold, each matched by name suffix
STATE_SUFFIXES = STACK_NAMES + ("lnf_gamma", "lnf_beta", "tok_embed_weight",
                                "pos_embed_weight")


def _targets(model):
    """The model's parameters by serving-checkpoint suffix."""
    return {n: getattr(model if n.endswith("_embed_weight") else model.encoder,
                       n) for n in STATE_SUFFIXES}


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
    _copy_checked(_targets(model), arrays, what)


def _copy_checked(targets, arrays, what):
    """Copy ``arrays[name]`` into each ``targets[name]`` parameter after
    checking every shape."""
    tensors = {}
    for name, param in targets.items():
        t = tensors[name] = as_tensor(arrays[name], name, what)
        if t.shape != param.shape:
            raise MXNetError(f"{what}: {name!r} has shape {tuple(t.shape)}, "
                             f"the model wants {tuple(param.shape)}")
    with torch.no_grad():
        for name, param in targets.items():
            param.copy_(tensors[name])


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
                f"load_stacks")
        if len(keys) > 1:
            raise MXNetError(f"{what}: {len(keys)} entries end "
                             f"{suffix!r}: {sorted(keys)}")
        arrays[suffix] = state[keys[0]]
    return arrays


def load_state(model, state):
    """Load a scanned-trunk serving checkpoint ``{name: np.ndarray}`` into
    a port ``GPTModel``.  Entries are matched by name suffix; extra
    entries are ignored."""
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


#: the port BERTModel's parameter names that differ from the JAX
#: model's, which follow the model's prefix (``bertmodel0_``); the Gluon
#: LayerNorms are numbered in creation order (``embed_ln`` first)
BERT_NAMES = {
    "embed_ln.gamma": "layernorm0_gamma",
    "embed_ln.beta": "layernorm0_beta",
    "decoder_ln.gamma": "layernorm1_gamma",
    "decoder_ln.beta": "layernorm1_beta",
    "pooler.weight": "pooler_weight",
    "pooler.bias": "pooler_bias",
    "nsp_classifier.weight": "nsp_weight",
    "nsp_classifier.bias": "nsp_bias",
    "decoder_transform.weight": "dec_transform_weight",
    "decoder_transform.bias": "dec_transform_bias",
}
#: a per-layer (``scan_layers=False``) trunk's names for a stack's slice i
#: (``enc_layer{i}_`` + name) and for the final LayerNorm (``enc_`` + name)
_LAYER_NAMES = {"ln1_stack_gamma": "layernorm0_gamma",
                "ln1_stack_beta": "layernorm0_beta",
                "ln2_stack_gamma": "layernorm1_gamma",
                "ln2_stack_beta": "layernorm1_beta",
                "lnf_gamma": "layernorm0_gamma",
                "lnf_beta": "layernorm0_beta"}


def _bert_keys(name, prefix, per_layer, num_layers):
    """The JAX names that make up port parameter ``name``: one, or a
    per-layer trunk's ``num_layers`` slices of a stack."""
    if not name.startswith("encoder."):
        return [prefix + BERT_NAMES.get(name, name)]
    short = name[len("encoder."):]
    if not per_layer:
        return [prefix + "enc_" + short]
    if short.startswith("lnf_"):
        return [prefix + "enc_" + _LAYER_NAMES[short]]
    layer = _LAYER_NAMES.get(short, short.replace("_stack", ""))
    return [f"{prefix}enc_layer{i}_{layer}" for i in range(num_layers)]


def load_bert_params(model, params):
    """Load a JAX ``BERTModel``'s ``{name: np.ndarray}`` (its
    ``collect_params()`` as numpy) into a port ``BERTModel``.  The JAX
    model's prefix is read off its one ``*word_embed_weight`` entry; every
    port parameter then takes the entry of the JAX name after that prefix
    (``BERT_NAMES``), a per-layer trunk's ``enc_layer{i}_*`` entries
    stacked into the ``*_stack_*`` tensors.  Raises on a missing,
    duplicate, mis-shaped or unused entry under the prefix before copying
    anything."""
    what = "load_bert_params"
    roots = [k for k in params if k.endswith("word_embed_weight")]
    if len(roots) != 1:
        raise MXNetError(f"{what}: want one entry ending 'word_embed_weight', "
                         f"found {sorted(roots)}")
    prefix = roots[0][:-len("word_embed_weight")]
    per_layer = prefix + "enc_qkv_stack_weight" not in params
    num_layers = model.encoder._num_layers
    if per_layer and prefix + "enc_layer0_qkv_weight" not in params:
        raise MXNetError(f"{what}: no trunk under {prefix + 'enc_'!r} "
                         f"(neither a scanned nor a per-layer encoder)")
    targets = dict(model.named_parameters())
    arrays, used = {}, set()
    for name in targets:
        keys = _bert_keys(name, prefix, per_layer, num_layers)
        missing = [k for k in keys if k not in params]
        if missing:
            raise MXNetError(f"{what}: {name!r} wants {missing}, not given")
        for k in keys:
            _check_array(params[k], k, what)
        stacked = per_layer and name.startswith("encoder.") \
            and not name.startswith("encoder.lnf_")
        if stacked and len({params[k].shape for k in keys}) > 1:
            raise MXNetError(f"{what}: the layers of {name!r} differ in "
                             f"shape: {[params[k].shape for k in keys]}")
        arrays[name] = (np.stack([params[k] for k in keys]) if stacked
                        else params[keys[0]])
        used.update(keys)
    unused = sorted(k for k in params if k.startswith(prefix) and
                    k not in used)
    if unused:
        raise MXNetError(f"{what}: entries the port model has no parameter "
                         f"for: {unused}")
    _copy_checked(targets, arrays, what)


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
