"""NDArray serialization: ``mx.nd.save`` / ``mx.nd.load``.

Counterpart of ``mxnet_tpu/ndarray/utils.py``, in its byte layout
(little-endian), so a file either package writes loads in the other:

  container:  uint64 0x112 (kMXAPINDArrayListMagic), uint64 reserved=0,
              uint64 n_arrays, n_arrays x NDArray records,
              uint64 n_names, n_names x (uint64 len, bytes) names
  ndarray:    uint32 0xF993fac9 (NDARRAY_V2_MAGIC), int32 stype (-1 dense),
              uint32 ndim, int64[ndim] shape, int32 dev_type, int32 dev_id,
              int32 type_flag, raw data bytes

Type flags are mshadow's (float32 0, float64 1, float16 2, uint8 3,
int32 4, int8 5, int64 6) plus the JAX package's extension flag 12 for
bfloat16; bool saves as uint8.  Dense records only: the sparse records
(the JAX package's 0xF993facA extension, or a sparse stype under the v2
magic) raise MXNetError until sparse storage is ported.  Loaded arrays
land on ``ctx``, default ``current_context()``.
"""

from __future__ import annotations

import struct

import numpy as _np
import torch

from ..base import MXNetError
from .ndarray import NDArray

_LIST_MAGIC = 0x112
_ND_MAGIC_V2 = 0xF993FAC9
_ND_MAGIC_V1 = 0xF993FAC8
_ND_MAGIC_SPARSE = 0xF993FACA

# reference type flags (mshadow/base.h)
_TYPE_FLAGS = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6,
}
_FLAG_TYPES = {v: k for k, v in _TYPE_FLAGS.items()}
_BF16_FLAG = 12  # extension flag for bfloat16 (not in 1.x reference)


def _flag_and_bytes(t):
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return _BF16_FLAG, t.view(torch.int16).numpy().tobytes()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.dtype not in _TYPE_FLAGS:
        t = t.to(torch.float32)
    return _TYPE_FLAGS[t.dtype], t.numpy().tobytes()


def _save_ndarray(f, arr: NDArray):
    flag, raw = _flag_and_bytes(arr._data)
    shape = arr.shape
    f.write(struct.pack("<I", _ND_MAGIC_V2))
    f.write(struct.pack("<i", -1))
    f.write(struct.pack("<I", len(shape)))
    if shape:
        f.write(struct.pack(f"<{len(shape)}q", *shape))
    f.write(struct.pack("<ii", 1, 0))  # context: cpu(0), stripped on save
    f.write(struct.pack("<i", flag))
    f.write(raw)


def _read_values(f, flag, shape, device):
    n = 1
    for s in shape:
        n *= s
    if flag == _BF16_FLAG:
        raw = _np.frombuffer(f.read(2 * n), dtype=_np.int16).copy()
        t = torch.from_numpy(raw).view(torch.bfloat16)
    elif flag in _FLAG_TYPES:
        dt = _FLAG_TYPES[flag]
        size = torch.empty((), dtype=dt).element_size()
        np_dt = torch.empty((), dtype=dt).numpy().dtype
        raw = _np.frombuffer(f.read(size * n), dtype=np_dt).copy()
        t = torch.from_numpy(raw)
    else:
        raise MXNetError(f"unknown NDArray type flag {flag}")
    return t.reshape(tuple(shape)).to(device)


def _load_ndarray(f, device) -> NDArray:
    (magic,) = struct.unpack("<I", f.read(4))
    if magic == _ND_MAGIC_SPARSE:
        raise MXNetError("sparse NDArray records are not supported: the "
                         "port has no sparse storage yet")
    if magic == _ND_MAGIC_V2:
        (stype,) = struct.unpack("<i", f.read(4))
        if stype != -1:
            raise MXNetError(f"sparse storage type {stype} under the "
                             "upstream v2 magic is not supported")
        (ndim,) = struct.unpack("<I", f.read(4))
        shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()
    elif magic == _ND_MAGIC_V1:
        (ndim,) = struct.unpack("<I", f.read(4))
        shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim)) if ndim else ()
    else:
        raise MXNetError(f"invalid NDArray magic {magic:#x}")
    struct.unpack("<ii", f.read(8))  # context (ignored; load to ctx)
    (flag,) = struct.unpack("<i", f.read(4))
    return NDArray(_read_values(f, flag, shape, device))


def save(fname: str, data) -> None:
    """Save an NDArray, a list, or a str -> NDArray dict (``.params``)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [], list(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _save_ndarray(f, a)
        f.write(struct.pack("<Q", len(names)))
        for nme in names:
            b = nme.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname: str, ctx=None):
    """Load a ``.params`` file: a dict (named) or a list (unnamed)."""
    from ..context import current_context

    device = (ctx or current_context()).device
    with open(fname, "rb") as f:
        magic, _ = struct.unpack("<QQ", f.read(16))
        if magic != _LIST_MAGIC:
            raise MXNetError(f"invalid .params magic {magic:#x}")
        (count,) = struct.unpack("<Q", f.read(8))
        arrays = [_load_ndarray(f, device) for _ in range(count)]
        (n_names,) = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(n_names):
            (ln,) = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode("utf-8"))
    if names:
        return dict(zip(names, arrays))
    return arrays
