"""Checkpoint helpers of the symbolic path.

Counterpart of ``mxnet_tpu/model.py`` (reference: python/mxnet/model.py):
``save_checkpoint``/``load_checkpoint``, the ``prefix-symbol.json`` plus
``prefix-NNNN.params`` pair with ``arg:``/``aux:`` keys (the ``.params``
format the two packages share), and the ``BatchEndParam`` bundle the
training loop hands its callbacks.
"""

from __future__ import annotations

import os
from collections import namedtuple

from .ndarray import load as nd_load
from .ndarray import save as nd_save

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{name}": v for name, v in arg_params.items()}
    save_dict.update({f"aux:{name}": v for name, v in aux_params.items()})
    nd_save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint; the arrays land
    on ``ctx`` (default ``current_context()``), the symbol is None when
    the pair has no ``-symbol.json``."""
    from . import symbol as sym_mod

    symbol = None
    if os.path.exists(f"{prefix}-symbol.json"):
        symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in nd_load(f"{prefix}-{epoch:04d}.params", ctx=ctx).items():
        tp, _, name = k.partition(":")
        if tp == "aux":
            aux_params[name] = v
        else:
            arg_params[name if tp == "arg" else k] = v
    return symbol, arg_params, aux_params
