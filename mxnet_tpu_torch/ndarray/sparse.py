"""mx.nd.sparse: compact sparse storage and its operators.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
python/mxnet/ndarray/sparse.py over src/ndarray/ndarray.cc's sparse
chunks).  Storage is compact; dense operators read a dense view that an
operator materialises on demand:

- ``RowSparseNDArray`` holds (indices (K,), values (K, cols...)) and the
  logical shape: O(K) memory, never O(rows), until an operator asks for
  the dense view (``_data``);
- ``CSRNDArray`` holds (data (nnz,), indices (nnz,), indptr (rows+1,)),
  the input format (``io.LibSVMIter``); ``dot`` multiplies it with a
  dense matrix from the compact parts, forward and backward, with no
  (rows, cols) view;
- ``Embedding(sparse_grad=True)`` and ``ShardedEmbedding`` give a
  row-sparse weight gradient on the eager tape (``autograd.py`` writes it
  into a ``RowSparseNDArray`` gradient buffer), and the optimizers update
  just its rows (lazy update).

Indices are int64 tensors (the JAX package's are int32; ``asnumpy``
compares equal).  Every sum over duplicate row ids goes through
``segment_sum``: ``index_put_(accumulate=True)`` into a zeroed
accumulator, which adds each row's contributions in the order they come
(a stable sort on the card, one pass on the host), so the same inputs
give the same bits on every run, and a row-sparse gradient summed in the
captured step (``embedding.prep.rows_lookup``) equals the eager one.
"""

from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import context_of
from .ndarray import NDArray, host_dtype


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def segment_sum(values, seg, n):
    """``(n, cols...)``: the rows of ``values`` summed per segment id in
    ``seg`` (int64), accumulated in f32 (f64 for f64) in the order the
    rows come and cast back to ``values``' dtype.  A segment no row
    targets is zero."""
    out = torch.zeros((n,) + tuple(values.shape[1:]),
                      dtype=_acc_dtype(values.dtype), device=values.device)
    out.index_put_((seg,), values.to(out.dtype), accumulate=True)
    return out.to(values.dtype)


def coalesce(indices, values):
    """Sorted unique row ids and their summed rows (``segment_sum``).
    ``torch.unique`` sizes its output on the host: eager only."""
    uniq, inv = torch.unique(indices, sorted=True, return_inverse=True)
    return uniq, segment_sum(values, inv, uniq.numel())


def sparse_grad(indices, values, shape):
    """The row-sparse cotangent on torch's tape: a sparse COO tensor with
    one sparse dimension.  ``indices`` must be sorted and unique."""
    return torch.sparse_coo_tensor(indices[None], values, tuple(shape),
                                   is_coalesced=True,
                                   check_invariants=False)


def _device(ctx):
    from ..context import current_context

    return (ctx or current_context()).device


def _as_tensor(x, device, dtype=None):
    """An NDArray, tensor, numpy array or list as a tensor on ``device``;
    64-bit host values arrive in 32 bits unless ``dtype`` says otherwise,
    as ``nd.array`` delivers them."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = _np.asarray(x)
        if dtype is None:
            a = a.astype(host_dtype(a.dtype))
        t = torch.from_numpy(_np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(device)


def _sparsify_rows(t):
    """Dense (R, cols...) -> (indices, values) of its nonzero rows, on
    its device."""
    mask = (t.reshape(t.shape[0], -1) != 0).any(dim=1)
    idx = torch.nonzero(mask)[:, 0]
    return idx, t.index_select(0, idx)


def _sparsify_csr(a):
    """Dense 2-D numpy -> (data, indices, indptr) numpy parts."""
    a = _np.asarray(a)
    counts = (a != 0).sum(axis=1)
    return (a[a != 0], _np.nonzero(a)[1].astype(_np.int64),
            _np.concatenate([[0], _np.cumsum(counts)]).astype(_np.int64))


class BaseSparseNDArray(NDArray):
    """Common ground of the compact arrays: the dense view is the
    ``_data`` property, and whatever a dense NDArray reads from its tensor
    that the compact parts already know is answered from them."""

    __slots__ = ()

    def _parts(self):
        raise NotImplementedError

    def _init_state(self, ctx):
        self._ctx = ctx
        self._version = 0
        self._grad = None
        self._grad_req = "null"
        self._leaf = None
        self._fresh_grad = False

    @property
    def shape(self):
        return self._logical_shape

    @property
    def size(self):
        n = 1
        for s in self._logical_shape:
            n *= s
        return n

    @property
    def ndim(self):
        return len(self._logical_shape)

    @property
    def context(self):
        return self._ctx if self._ctx is not None \
            else context_of(self._parts()[0].device)

    ctx = context

    def _on_tape(self):
        return self._grad_req != "null"

    def wait_to_read(self):
        t = self._parts()[0]
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return self

    wait_to_write = wait_to_read

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        out = self.copy()
        out._move(ctx.device)
        out._ctx = ctx
        return out

    as_in_ctx = as_in_context

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data, self._ctx)
        return cast_storage(self, stype)

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError(f"attach_grad on a {self.stype} array: gradients "
                         "flow to dense arrays")


class RowSparseNDArray(BaseSparseNDArray):
    """Compact row-sparse array: (indices, values) and the logical shape.
    Indices may repeat until ``coalesce``; the dense view sums them."""

    __slots__ = ("_rs_indices", "_rs_values", "_logical_shape")

    def __init__(self, indices, values, shape, ctx=None):
        self._rs_values = values
        self._rs_indices = indices.to(device=values.device,
                                      dtype=torch.int64)
        self._logical_shape = tuple(int(s) for s in shape)
        self._init_state(ctx)

    def _parts(self):
        return self._rs_values, self._rs_indices

    def _move(self, device):
        self._rs_values = self._rs_values.to(device)
        self._rs_indices = self._rs_indices.to(device)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        return NDArray(self._rs_indices.clone(), self._ctx)

    @property
    def data(self):
        return NDArray(self._rs_values.clone(), self._ctx)

    @property
    def num_stored_rows(self):
        return int(self._rs_indices.shape[0])

    @property
    def dtype(self):
        return np_dtype(self._rs_values.dtype)

    @property
    def _data(self):
        base = torch.zeros(self._logical_shape, dtype=self._rs_values.dtype,
                           device=self._rs_values.device)
        return base.index_put_((self._rs_indices,), self._rs_values,
                               accumulate=True)

    @_data.setter
    def _data(self, t):
        self._set_data(t)

    def _set_data(self, t):
        """A dense write-back is sparsified to its nonzero rows; a sparse
        COO tensor is taken as its parts."""
        if t.is_sparse:
            self._set_sparse(t._indices()[0], t._values())
            return
        idx, vals = _sparsify_rows(t.detach())
        self._rs_indices, self._rs_values = idx, vals
        self._logical_shape = tuple(int(s) for s in t.shape)
        self._version += 1

    def _set_sparse(self, indices, values):
        self._rs_values = values.detach()
        self._rs_indices = indices.to(device=values.device,
                                      dtype=torch.int64)
        self._version += 1

    def copy(self):
        return RowSparseNDArray(self._rs_indices.clone(),
                                self._rs_values.clone(),
                                self._logical_shape, self._ctx)

    def __repr__(self):
        return (f"\n<RowSparseNDArray {self._logical_shape} "
                f"({self.num_stored_rows} stored rows)>")


class CSRNDArray(BaseSparseNDArray):
    """Compact CSR matrix: (data, indices, indptr) and the logical shape
    (the input format: ``io.LibSVMIter``)."""

    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr",
                 "_logical_shape")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        self._csr_data = data
        self._csr_indices = indices.to(device=data.device, dtype=torch.int64)
        self._csr_indptr = indptr.to(device=data.device, dtype=torch.int64)
        self._logical_shape = tuple(int(s) for s in shape)
        self._init_state(ctx)

    def _parts(self):
        return self._csr_data, self._csr_indices, self._csr_indptr

    def _move(self, device):
        self._csr_data = self._csr_data.to(device)
        self._csr_indices = self._csr_indices.to(device)
        self._csr_indptr = self._csr_indptr.to(device)

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._csr_indptr.clone(), self._ctx)

    @property
    def indices(self):
        return NDArray(self._csr_indices.clone(), self._ctx)

    @property
    def data(self):
        return NDArray(self._csr_data.clone(), self._ctx)

    @property
    def dtype(self):
        return np_dtype(self._csr_data.dtype)

    @property
    def _data(self):
        rows = _csr_rows_of(self._csr_indptr, self._csr_data.shape[0])
        base = torch.zeros(self._logical_shape, dtype=self._csr_data.dtype,
                           device=self._csr_data.device)
        return base.index_put_((rows, self._csr_indices), self._csr_data)

    @_data.setter
    def _data(self, t):
        self._set_data(t)

    def _set_data(self, t):
        a = t.detach().cpu().numpy()
        data, indices, indptr = _sparsify_csr(a)
        dev = t.device
        self._csr_data = torch.from_numpy(data).to(dev)
        self._csr_indices = torch.from_numpy(indices).to(dev)
        self._csr_indptr = torch.from_numpy(indptr).to(dev)
        self._logical_shape = tuple(a.shape)
        self._version += 1

    def copy(self):
        return CSRNDArray(self._csr_data.clone(), self._csr_indices.clone(),
                          self._csr_indptr.clone(), self._logical_shape,
                          self._ctx)

    def __repr__(self):
        return (f"\n<CSRNDArray {self._logical_shape} "
                f"({int(self._csr_data.shape[0])} stored values)>")


# -- constructors --------------------------------------------------------------

def _host(x):
    return _np.asarray(x.asnumpy() if isinstance(x, NDArray) else x)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``RowSparseNDArray`` from ``(data, indices)`` or from a dense
    array (its nonzero rows, found on its device)."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    dev = _device(ctx)
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2 \
            and not isinstance(arg1[0], (int, float)):
        data, indices = arg1
        vals = _as_tensor(data, dev, dtype)
        idx = torch.as_tensor(_host(indices).astype(_np.int64),
                              device=dev).reshape(-1)
        full = shape or (((int(idx.max()) + 1) if idx.numel() else 0,)
                         + tuple(vals.shape[1:]))
        return RowSparseNDArray(idx, vals, full, ctx)
    if isinstance(arg1, NDArray):
        raw = arg1._data.detach()
        if dtype is not None:
            raw = raw.to(torch_dtype(dtype))
    else:
        raw = _as_tensor(arg1, dev, dtype or "float32")
    idx, vals = _sparsify_rows(raw)
    return RowSparseNDArray(idx, vals, raw.shape,
                            ctx or getattr(arg1, "_ctx", None))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``CSRNDArray`` from ``(data, indices, indptr)`` or from a dense
    2-D array (its dtype kept; a list is float32)."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    dev = _device(ctx if ctx is not None else getattr(arg1, "_ctx", None))
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data, indices, indptr = (_host(x) for x in arg1)
        n_rows = len(indptr) - 1
        n_cols = shape[1] if shape else int(indices.max()) + 1
        data = data.astype(dtype or host_dtype(data.dtype))
        return CSRNDArray(torch.from_numpy(_np.ascontiguousarray(data))
                          .to(dev),
                          torch.as_tensor(indices.astype(_np.int64)),
                          torch.as_tensor(indptr.astype(_np.int64)),
                          (n_rows, n_cols), ctx)
    a = _host(arg1)
    a = a.astype(dtype or (a.dtype if a.dtype != _np.object_
                           else "float32"))
    if not isinstance(arg1, NDArray):
        a = a.astype(host_dtype(a.dtype))
    data, indices, indptr = _sparsify_csr(a)
    return CSRNDArray(torch.from_numpy(data).to(dev),
                      torch.from_numpy(indices), torch.from_numpy(indptr),
                      a.shape, ctx)


# -- CSR times dense -----------------------------------------------------------
#
# The reference's DotCsrDnsDns / DotCsrTransDnsDns (src/operator/tensor/
# dot.cc) from the compact parts: a gather and a segment sum, O(nnz * D),
# never a (rows, cols) view of the sparse matrix.


def _csr_rows_of(indptr, nnz):
    """The (nnz,) row id of each stored value: row r owns positions
    indptr[r] <= p < indptr[r+1]."""
    pos = torch.arange(nnz, device=indptr.device)
    return torch.searchsorted(indptr, pos, right=True) - 1


def csr_dot_dense(data, indices, indptr, rhs, out_rows, transpose_a=False):
    """CSR @ dense from the parts.  data (nnz,), indices (nnz,), indptr
    (rows+1,), rhs 2-D.  transpose_a=False: (rows, C) @ (C, D) -> (rows,
    D), out_rows = rows; transpose_a=True: (rows, C)^T @ (rows, D) -> (C,
    D), out_rows = C."""
    rows = _csr_rows_of(indptr, data.shape[0])
    if transpose_a:
        contrib = data[:, None].to(rhs.dtype) * rhs.index_select(0, rows)
        return segment_sum(contrib, indices, out_rows)
    gathered = data[:, None].to(rhs.dtype) * rhs.index_select(0, indices)
    return segment_sum(gathered, rows, out_rows)


class _CsrDot(torch.autograd.Function):
    """CSR @ dense with the gradient for the dense operand only; the
    gradient is the compact kernel again, transposed (dRhs = csr^T @
    dy)."""

    @staticmethod
    def forward(ctx, rhs, data, indices, indptr, out_rows, in_rows,
                transpose_a):
        ctx.save_for_backward(data, indices, indptr)
        ctx.in_rows, ctx.transpose_a = in_rows, transpose_a
        return csr_dot_dense(data, indices, indptr, rhs, out_rows,
                             transpose_a)

    @staticmethod
    def backward(ctx, g):
        data, indices, indptr = ctx.saved_tensors
        drhs = csr_dot_dense(data, indices, indptr, g.contiguous(),
                             ctx.in_rows, not ctx.transpose_a)
        return drhs, None, None, None, None, None, None


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference: mx.nd.sparse.dot).  A CSR ``lhs``
    runs the compact kernels above, forward and backward; a dense ``lhs``
    is the dense op."""
    from .register import invoke_registered, invoke_simple

    if not isinstance(lhs, CSRNDArray):
        return invoke_registered(
            "dot", (lhs, rhs),
            {"transpose_a": transpose_a, "transpose_b": transpose_b})
    if transpose_b:
        raise MXNetError("sparse.dot: transpose_b unsupported for CSR lhs "
                         "(reference: dot.cc has no CsrDns^T kernel)")
    n_rows, n_cols = lhs._logical_shape
    need = n_rows if transpose_a else n_cols
    if rhs.shape[0] != need:
        raise MXNetError(
            f"sparse.dot: shape mismatch {lhs._logical_shape}"
            f"{'^T' if transpose_a else ''} @ {tuple(rhs.shape)}")
    out_rows = n_cols if transpose_a else n_rows
    parts = lhs._parts()

    def fn(r):
        return _CsrDot.apply(r, *parts, out_rows, need, bool(transpose_a))

    return invoke_simple(fn, (rhs,), name="sparse_dot")


# -- row-sparse elementwise ----------------------------------------------------

def _coalesced_parts(rsp):
    return coalesce(rsp._rs_indices, rsp._rs_values)


def _on_eager_tape(*arrs):
    """Whether autograd records and an operand is on the tape: the
    compact paths below do not record, so they defer to the dense op,
    which does."""
    from .. import autograd as _ag

    return _ag.is_recording() and any(
        getattr(a, "_on_tape", lambda: False)() for a in arrs)


def _select_stored_rows(idx_sorted, wanted_sorted):
    """Positions of the entries of ``idx_sorted`` present in
    ``wanted_sorted``."""
    return torch.nonzero(torch.isin(idx_sorted, wanted_sorted))[:, 0]


def _promote(a, b):
    return torch.promote_types(a._rs_values.dtype, b._rs_values.dtype)


def add(lhs, rhs):
    """Compact row-sparse add (reference: elemwise_add's rsp+rsp kernel):
    the union of the stored rows, O(K1 + K2).  Mixed sparse and dense
    operands, or operands on the tape, take the dense op."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray) and \
            not _on_eager_tape(lhs, rhs):
        if lhs._logical_shape != rhs._logical_shape:
            raise MXNetError(f"sparse.add: shape mismatch "
                             f"{lhs._logical_shape} vs {rhs._logical_shape}")
        dt = _promote(lhs, rhs)
        idx, vals = coalesce(
            torch.cat([lhs._rs_indices, rhs._rs_indices]),
            torch.cat([lhs._rs_values.to(dt), rhs._rs_values.to(dt)]))
        return RowSparseNDArray(idx, vals, lhs._logical_shape, lhs._ctx)
    from .register import invoke_registered

    return invoke_registered("elemwise_add", (lhs, rhs), {})


def elemwise_mul(lhs, rhs):
    """Compact row-sparse multiply: the stored rows are the intersection
    (reference: elemwise_mul rsp*rsp).  Operands on the tape take the
    dense op, as in ``add``."""
    if not (isinstance(lhs, RowSparseNDArray)
            and isinstance(rhs, RowSparseNDArray)) \
            or _on_eager_tape(lhs, rhs):
        from .register import invoke_registered

        return invoke_registered("elemwise_mul", (lhs, rhs), {})
    if lhs._logical_shape != rhs._logical_shape:
        raise MXNetError(f"sparse.elemwise_mul: shape mismatch "
                         f"{lhs._logical_shape} vs {rhs._logical_shape}")
    li, lv = _coalesced_parts(lhs)
    ri, rv = _coalesced_parts(rhs)
    dt = _promote(lhs, rhs)
    keep = _select_stored_rows(li, ri)
    out_rows = li.index_select(0, keep)
    rpos = torch.searchsorted(ri, out_rows)
    vals = lv.index_select(0, keep).to(dt) * rv.index_select(0, rpos).to(dt)
    return RowSparseNDArray(out_rows, vals, lhs._logical_shape, lhs._ctx)


def retain(arr, indices):
    """Only the requested rows of a ``RowSparseNDArray`` (reference:
    mx.nd.sparse.retain), compact in and out."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("sparse.retain expects a RowSparseNDArray")
    si, sv = _coalesced_parts(arr)
    want = torch.as_tensor(_np.unique(_host(indices).astype(
        _np.int64).ravel()), device=si.device)
    keep = _select_stored_rows(si, want)
    return RowSparseNDArray(si.index_select(0, keep),
                            sv.index_select(0, keep), arr._logical_shape,
                            arr._ctx)


def cast_storage(arr, stype):
    """Storage casting (reference: mx.nd.cast_storage,
    src/operator/tensor/cast_storage.cc): real compact arrays, dtype
    kept."""
    if stype == "default":
        return NDArray(arr._data, arr._ctx) \
            if isinstance(arr, BaseSparseNDArray) else arr
    if stype == "csr":
        return arr if isinstance(arr, CSRNDArray) else csr_matrix(arr)
    if stype == "row_sparse":
        if isinstance(arr, RowSparseNDArray):
            return arr
        if isinstance(arr, CSRNDArray):
            arr = NDArray(arr._data, arr._ctx)
        return row_sparse_array(arr)
    raise MXNetError(f"cast_storage: unknown stype {stype!r}")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of ``stype``: no stored rows or values."""
    from . import zeros as dense_zeros

    dev = _device(ctx)
    dt = torch_dtype(dtype or "float32")
    shape = tuple(shape)
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray(
            empty, torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            shape, ctx)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev), empty,
                          torch.zeros((shape[0] + 1,), dtype=torch.int64),
                          shape, ctx)
    return dense_zeros(shape, ctx, dtype)
