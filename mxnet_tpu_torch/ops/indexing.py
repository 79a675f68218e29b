"""Indexing, gather and scatter ops on tensors.

Counterpart of ``mxnet_tpu/ops/indexing.py`` (reference:
src/operator/tensor/indexing_op.cc: take, Embedding, one_hot, gather_nd,
scatter_nd, pick, batch_take; the Sequence* ops; contrib boolean_mask,
index_copy, index_array, allclose).  Indices may arrive as float tensors
(the reference's habit); they are cast to int64.  Scatters are
out-of-place (``index_put``), as the JAX ``.at[]`` updates are.
``sparse_embedding`` is the eager Embedding whose weight gradient is
row-sparse (``Embedding(sparse_grad=True)``).
"""

from __future__ import annotations

import builtins

import torch

from .._parallel_scope import current_scope
from ..base import torch_dtype
from .registry import register


def _idx(t):
    return t.long()


@register("take")
def take(a, indices, axis=0, mode="clip"):
    n = a.shape[axis]
    idx = _idx(indices)
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    axis = axis % a.dim()
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take")
def batch_take(a, indices):
    return torch.gather(a, -1, _idx(indices)[..., None]).squeeze(-1)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    idx = _idx(index).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("one_hot")
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    hot = _idx(indices)[..., None] == torch.arange(depth,
                                                   device=indices.device)
    dt = torch_dtype(dtype)
    on = torch.tensor(on_value, dtype=dt, device=indices.device)
    off = torch.tensor(off_value, dtype=dt, device=indices.device)
    return torch.where(hot, on, off)


@register("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` at the (clipped) ids.  Inside a sharded step a
    weight sharded on its vocabulary (a tp shard of dim 0) looks up the
    ids in its own rows, zeros the rest, and sums the ranks' rows over
    the tp group (vocab-parallel embedding)."""
    scope = current_scope()
    shard = scope.shard_of(weight) if scope is not None else None
    if shard is None:
        return weight[_idx(data).clamp(0, weight.shape[0] - 1)]
    from ..parallel.collectives import reduce_from_region

    dim, offset, full = shard
    if dim != 0:
        from ..base import MXNetError

        raise MXNetError("Embedding: a tp shard of the table must split "
                         "the vocabulary (dim 0)")
    ids = _idx(data).clamp(0, full - 1) - offset
    mine = (ids >= 0) & (ids < weight.shape[0])
    rows = weight[ids.clamp(0, weight.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_region(rows, scope.tp_group)


class _SparseEmbedding(torch.autograd.Function):
    """Embedding lookup whose weight gradient is a row-sparse cotangent:
    the batch's unique rows (sorted) and their summed cotangents,
    accumulated in f32 and cast to the table's dtype.  The ids are
    clipped once, so the backward scatters at the rows the forward
    read."""

    @staticmethod
    def forward(ctx, data, weight):
        ids = _idx(data).clamp(0, weight.shape[0] - 1)
        ctx.save_for_backward(ids)
        ctx.wshape = tuple(weight.shape)
        return weight.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + ctx.wshape[1:])

    @staticmethod
    def backward(ctx, g):
        from ..ndarray.sparse import segment_sum, sparse_grad

        (ids,) = ctx.saved_tensors
        uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                                 return_inverse=True)
        vals = segment_sum(g.reshape((-1,) + ctx.wshape[1:]), inv,
                           uniq.numel())
        return None, sparse_grad(uniq, vals, ctx.wshape)


def sparse_embedding(data, weight):
    """Eager Embedding with a compact row-sparse weight gradient, O(touched
    rows) (reference: indexing_op.cc's backward into a row_sparse
    gradient).  Tensors in, a tensor out; NDArrays in, an NDArray out,
    recorded while ``autograd.record()`` is open.  Out-of-range ids read
    and receive the gradient of the clipped row."""
    from ..ndarray.ndarray import NDArray

    if isinstance(data, NDArray) or isinstance(weight, NDArray):
        from ..ndarray.register import invoke_simple

        return invoke_simple(sparse_embedding, (data, weight),
                             name="sparse_embedding")
    return _SparseEmbedding.apply(data, weight)


@register("gather_nd")
def gather_nd(data, indices):
    return data[tuple(_idx(indices))]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_idx(indices)), data)


@register("_contrib_index_copy", aliases=("index_copy",))
def index_copy(old, index, new):
    """Reference: contrib/index_copy.cc (out-of-place, as the JAX op)."""
    return old.index_put((_idx(index),), new)


@register("index_add")
def index_add(old, index, new):
    return old.index_put((_idx(index),), new, accumulate=True)


@register("_contrib_boolean_mask", aliases=("boolean_mask",))
def boolean_mask(data, index, axis=0):
    # a dynamic-shape op (src/operator/contrib/boolean_mask.cc): the kept
    # count is read back to the host, as the JAX op does
    rows = torch.nonzero(index.bool().reshape(-1)).reshape(-1)
    return torch.index_select(data, axis, rows)


@register("sequence_mask", aliases=("SequenceMask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    # sequence axis is `axis` (0 or 1), batch is the other of the first two
    batch_axis = 1 - axis
    mask = steps[:, None] < sequence_length[None, :]  # (seq, batch)
    if axis == 1:
        mask = mask.T
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    shape[batch_axis] = data.shape[batch_axis]
    return torch.where(mask.reshape(shape), data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        idx = [builtins.slice(None)] * data.dim()
        idx[axis] = -1
        return data[tuple(idx)]
    last = _idx(sequence_length) - 1
    moved = torch.movedim(data, axis, 0)  # (seq, batch, ...)
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = torch.movedim(data, axis, 0)
    steps = torch.arange(moved.shape[0], device=data.device)[:, None]
    L = _idx(sequence_length)[None, :]
    src = torch.where(steps < L, L - 1 - steps, steps)  # (seq, batch)
    src = src.reshape(src.shape + (1,) * (moved.dim() - 2))
    out = torch.gather(moved, 0, src.expand(moved.shape))
    return torch.movedim(out, 0, axis)


@register("unravel_index")
def unravel_index(data, shape=None):
    """Flat index -> multi-index rows (reference: tensor/ravel.cc)."""
    rest = _idx(data)
    rows = []
    for s in reversed([int(s) for s in shape]):
        rows.append(rest.remainder(s))
        rest = torch.div(rest, s, rounding_mode="floor")
    return torch.stack(rows[::-1]).to(data.dtype)


@register("ravel_multi_index")
def ravel_multi_index(data, shape=None):
    """Multi-index rows (N, ...) -> flat indices (reference: ravel.cc)."""
    strides, acc = [], 1
    for s in reversed([int(s) for s in shape]):
        strides.append(acc)
        acc *= s
    strides = torch.tensor(strides[::-1], dtype=data.dtype,
                           device=data.device)
    return torch.sum(data * strides.reshape((-1,) + (1,) * (data.dim() - 1)),
                     dim=0)


@register("_contrib_index_array", aliases=("index_array",))
def index_array(data, axes=None):
    """Per-element coordinates (reference: contrib/index_array.cc): shape
    data.shape + (len(axes),), int64."""
    sel = tuple(range(data.dim())) if axes is None \
        else tuple(int(a) % data.dim() for a in axes)
    coords = [torch.arange(data.shape[a], device=data.device).reshape(
        (1,) * a + (-1,) + (1,) * (data.dim() - a - 1)).expand(data.shape)
        for a in sel]
    return torch.stack(coords, dim=-1).to(torch.int64)


@register("_contrib_allclose", aliases=("allclose",))
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """Scalar 1.0/0.0 closeness test (reference: contrib/allclose_op.cc)."""
    return torch.isclose(a, b, rtol=rtol, atol=atol,
                         equal_nan=bool(equal_nan)).all().to(torch.float32)
