"""NDArray serialization: ``mx.nd.save`` / ``mx.nd.load``.

Counterpart of ``mxnet_tpu/ndarray/utils.py``, in its byte layout
(little-endian), so a file either package writes loads in the other:

  container:  uint64 0x112 (kMXAPINDArrayListMagic), uint64 reserved=0,
              uint64 n_arrays, n_arrays x NDArray records,
              uint64 n_names, n_names x (uint64 len, bytes) names
  ndarray:    uint32 0xF993fac9 (NDARRAY_V2_MAGIC), int32 stype (-1 dense),
              uint32 ndim, int64[ndim] shape, int32 dev_type, int32 dev_id,
              int32 type_flag, raw data bytes

  sparse:     uint32 0xF993facA (the JAX package's extension magic),
              int32 stype (1 row_sparse, 2 csr), uint32 ndim,
              int64[ndim] logical shape, int32 dev_type, int32 dev_id,
              int32 type_flag, then
                row_sparse: uint64 K, int64[K] indices, raw values
                csr:        uint64 nnz, int64[nnz] indices,
                            uint64 P, int64[P] indptr, raw data

Type flags are mshadow's (float32 0, float64 1, float16 2, uint8 3,
int32 4, int8 5, int64 6) plus the JAX package's extension flag 12 for
bfloat16; bool saves as uint8.  A sparse record is compact: a row-sparse
table with K stored rows writes K rows.  A sparse stype under the
upstream v2 magic raises MXNetError, as in the JAX package.  Loaded
arrays land on ``ctx``, default ``current_context()``.
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


_STYPE_ROW_SPARSE = 1
_STYPE_CSR = 2


def _write_header(f, magic, stype, shape, flag):
    f.write(struct.pack("<I", magic))
    f.write(struct.pack("<i", stype))
    f.write(struct.pack("<I", len(shape)))
    if shape:
        f.write(struct.pack(f"<{len(shape)}q", *shape))
    f.write(struct.pack("<ii", 1, 0))  # context: cpu(0), stripped on save
    f.write(struct.pack("<i", flag))


def _int64_bytes(t):
    return t.detach().to(torch.int64).cpu().numpy().tobytes()


def _save_ndarray(f, arr: NDArray):
    from .sparse import CSRNDArray, RowSparseNDArray

    if isinstance(arr, RowSparseNDArray):
        flag, raw = _flag_and_bytes(arr._rs_values)
        _write_header(f, _ND_MAGIC_SPARSE, _STYPE_ROW_SPARSE, arr.shape,
                      flag)
        f.write(struct.pack("<Q", arr.num_stored_rows))
        f.write(_int64_bytes(arr._rs_indices))
        f.write(raw)
        return
    if isinstance(arr, CSRNDArray):
        flag, raw = _flag_and_bytes(arr._csr_data)
        _write_header(f, _ND_MAGIC_SPARSE, _STYPE_CSR, arr.shape, flag)
        f.write(struct.pack("<Q", int(arr._csr_data.shape[0])))
        f.write(_int64_bytes(arr._csr_indices))
        f.write(struct.pack("<Q", int(arr._csr_indptr.shape[0])))
        f.write(_int64_bytes(arr._csr_indptr))
        f.write(raw)
        return
    flag, raw = _flag_and_bytes(arr._data)
    _write_header(f, _ND_MAGIC_V2, -1, arr.shape, flag)
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


def _read_int64(f, n, device):
    raw = _np.frombuffer(f.read(8 * n), dtype=_np.int64).copy()
    return torch.from_numpy(raw).to(device)


def _load_sparse(f, stype, shape, device):
    from .sparse import CSRNDArray, RowSparseNDArray

    struct.unpack("<ii", f.read(8))  # context
    (flag,) = struct.unpack("<i", f.read(4))
    if stype == _STYPE_ROW_SPARSE:
        (k,) = struct.unpack("<Q", f.read(8))
        idx = _read_int64(f, k, device)
        vals = _read_values(f, flag, (k,) + tuple(shape[1:]), device)
        return RowSparseNDArray(idx, vals, shape)
    (nnz,) = struct.unpack("<Q", f.read(8))
    indices = _read_int64(f, nnz, device)
    (nptr,) = struct.unpack("<Q", f.read(8))
    indptr = _read_int64(f, nptr, device)
    data = _read_values(f, flag, (nnz,), device)
    return CSRNDArray(data, indices, indptr, shape)


def _load_ndarray(f, device) -> NDArray:
    (magic,) = struct.unpack("<I", f.read(4))
    if magic == _ND_MAGIC_SPARSE:
        (stype,) = struct.unpack("<i", f.read(4))
        if stype not in (_STYPE_ROW_SPARSE, _STYPE_CSR):
            raise MXNetError(f"unknown sparse storage type {stype}")
        (ndim,) = struct.unpack("<I", f.read(4))
        shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()
        return _load_sparse(f, stype, shape, device)
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
