"""Pretrained parameter files.

Counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py`` (reference:
python/mxnet/gluon/model_zoo/model_store.py).  Files are looked up under
a local root (``~/.mxnet/models`` by default) and nothing is downloaded:
a missing file raises ``MXNetError``.  A ``.params`` file saved by
``save_parameters`` (this package's, the JAX package's or the
reference's: the NDArray container format) loads through
``Block.load_parameters``.
"""

from __future__ import annotations

import os

from ...base import MXNetError

_ROOT = os.path.join("~", ".mxnet", "models")


def get_model_file(name, root=_ROOT):
    """The path of ``name``'s parameter file under ``root`` (``None``: the
    default root): ``{name}.params``, else the last in sorted order of the
    files named ``{name}*.params``."""
    root = os.path.expanduser(root or _ROOT)
    file_path = os.path.join(root, f"{name}.params")
    if os.path.exists(file_path):
        return file_path
    candidates = []
    if os.path.isdir(root):
        candidates = [f for f in os.listdir(root)
                      if f.startswith(name) and f.endswith(".params")]
    if candidates:
        return os.path.join(root, sorted(candidates)[-1])
    raise MXNetError(
        f"Pretrained model file for '{name}' not found under {root}; "
        "nothing is downloaded: place the .params file there (files saved "
        "by the reference load too).")


def purge(root=_ROOT):
    """Delete every ``.params`` file under ``root``."""
    root = os.path.expanduser(root or _ROOT)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
