"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference:
python/mxnet/gluon/utils.py): ``split_data``/``split_and_load``,
``clip_global_norm``, ``check_sha1``, ``download`` (``file://`` URLs and
files already present only: it opens no network connection) and
``shape_is_known``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import warnings

import numpy as _np

from ..ndarray.ndarray import NDArray


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split along ``batch_axis`` into ``num_slice`` slices (reference:
    utils.split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's multiple of {num_slice} or set even_split=False to "
            "allow uneven partitioning of data.")
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    if batch_axis == 0:
        return [data[i * step:(i + 1) * step] if i < num_slice - 1
                else data[i * step:size] for i in range(num_slice)]
    from .. import ndarray as nd

    return [nd.slice_axis(data, batch_axis, i * step, (i + 1) * step)
            if i < num_slice - 1
            else nd.slice_axis(data, batch_axis, i * step, size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split and load the slices onto ``ctx_list`` (reference:
    utils.split_and_load)."""
    if not isinstance(data, NDArray):
        from .. import ndarray as nd

        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that the 2-norm of their
    concatenation is at most ``max_norm``; returns the norm before
    clipping (a float, or an NDArray with ``check_isfinite=False``)."""
    from .. import ndarray as nd

    assert len(arrays) > 0, "arrays must not be empty"
    ctx = arrays[0].context

    def _sq(array):
        x = array.reshape((-1,))
        return (x * x).sum().as_in_context(ctx)

    total_norm = _sq(arrays[0])
    for arr in arrays[1:]:
        total_norm = total_norm + _sq(arr)
    total_norm = total_norm.sqrt()
    if check_isfinite:
        total_norm_val = float(total_norm.asscalar())
        if not _np.isfinite(total_norm_val):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    scale = nd.minimum(scale, nd.ones_like(scale))
    for arr in arrays:
        arr *= scale.as_in_context(arr.context)
    if check_isfinite:
        return total_norm_val
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s sha1 is ``sha1_hash`` (reference:
    utils.check_sha1)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """Reference: utils.download, without the network: a file already at
    the target (with the right sha1 when one is given) is returned as it
    is, a ``file://`` URL is copied, and any other URL raises
    ``MXNetError`` naming where to put the file."""
    from ..base import MXNetError

    name = url.split("/")[-1]
    if path is None:
        fname = name
    elif os.path.isdir(path):
        fname = os.path.join(path, name)
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[7:], fname)
        return fname
    raise MXNetError(
        f"download of {url} needs network access, which this build does "
        f"not use; place the file at {fname}")


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known (none is 0)."""
    if shape is None:
        return False
    return all(d != 0 for d in shape)
