"""Matrix and shape-manipulation ops on tensors.

Counterpart of ``mxnet_tpu/ops/matrix.py`` (reference:
src/operator/tensor/matrix_op.cc, dot.cc).  ``dot`` is a plain product
(``torch.tensordot``), as the JAX op is an XLA product and not a Pallas
kernel.  Ops that torch answers with a view (reshape, transpose, slices,
broadcasts) return the view here; the NDArray layer copies a result that
shares storage with its input (``ndarray/register.py``).
"""

from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Reference dot semantics: reduce the last axis of lhs with the first
    of rhs (after optional transposes), N-D included."""
    if transpose_a and lhs.dim() > 1:
        lhs = torch.movedim(lhs, 0, -1)
    if transpose_b and rhs.dim() > 1:
        rhs = torch.movedim(rhs, -1, 0)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("transpose")
def transpose(data, axes=None):
    if axes is None or axes == ():
        axes = tuple(reversed(range(data.dim())))
    return data.permute(tuple(axes))


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False):
    """The reference's special codes 0 (keep), -1 (infer), -2 (copy rest),
    -3 (merge two), -4 (split): src/operator/tensor/matrix_op-inl.h
    ReshapeShape."""
    shape = tuple(int(s) for s in shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return data.reshape(shape)
    src = list(data.shape)
    if reverse:
        src = src[::-1]
        shape = tuple(reversed(shape))
    out: list[int] = []
    i = j = 0  # cursors into src and shape
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            elif b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:           # -1 or a size
            out.append(s)
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


@register("reshape_like")
def reshape_like(lhs, rhs):
    if isinstance(rhs, (tuple, list)) or isinstance(lhs, (tuple, list)):
        # the classic foot-gun: a multi-output net's tuple fed to a loss
        raise TypeError(
            "reshape_like: got a tuple/list operand — a multi-output "
            "network's result was passed where one array is expected "
            "(select the output first, e.g. out[0])")
    return lhs.reshape(rhs.shape)


@register("expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis)


@register("flatten", aliases=("Flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register("concat", aliases=("Concat",))
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


@register("stack")
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@register("split", aliases=("SliceChannel",))
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} equal parts")
    parts = list(torch.split(data, n // num_outputs, dim=axis))
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


def _index(data, idx):
    """``data[idx]`` for a tuple of slices and ints, negative steps
    included (torch slicing refuses them)."""
    out, dim = data, 0
    for it in idx:
        if isinstance(it, builtins.slice) and it.step is not None \
                and it.step < 0:
            rows = range(*it.indices(out.shape[dim]))
            out = out.index_select(dim, torch.tensor(
                list(rows), dtype=torch.long, device=out.device))
            dim += 1
        else:
            out = out[(builtins.slice(None),) * dim + (it,)]
            dim += isinstance(it, builtins.slice)
    return out


@register("slice")
def slice(data, begin=None, end=None, step=None):  # noqa: A001
    ndim = data.dim()
    begin = list(begin) + [None] * (ndim - len(begin))
    end = list(end) + [None] * (ndim - len(end))
    step = list(step or []) + [None] * (ndim - len(step or []))
    return _index(data, tuple(builtins.slice(b, e, s)
                              for b, e, s in zip(begin, end, step)))


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    idx = [builtins.slice(None)] * data.dim()
    idx[axis] = builtins.slice(begin, end)
    return data[tuple(idx)]


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    idx = [builtins.slice(None)] * data.dim()
    axes = axes or range(min(data.dim(), shape_like.dim()))
    for a in axes:
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    # F.pad lists (before, after) from the last axis backwards
    first = next((i for i, p in enumerate(pw) if p != (0, 0)), len(pw))
    flat = [v for p in reversed(pw[first:]) for v in p]
    if mode == "constant":
        return F.pad(data, flat, mode="constant", value=constant_value)
    tmode = {"edge": "replicate", "reflect": "reflect"}[mode]
    return F.pad(data, flat, mode=tmode)


@register("flip", aliases=("reverse",))
def flip(data, axis=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=axis)


@register("broadcast_to")
def broadcast_to(data, shape=None):
    shape = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return data.expand(shape)


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axis = axis if isinstance(axis, (list, tuple)) else (axis,)
    size = size if isinstance(size, (list, tuple)) else (size,)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return data.expand(tuple(shape))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("full_like")
def full_like(data, fill_value=0.0):
    return torch.full_like(data, fill_value)


@register("where")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("cast", aliases=("Cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("amp_cast")
def amp_cast(data, dtype="float16"):
    return data.to(torch_dtype(dtype))


@register("shape_array")
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("diag")
def diag(data, k=0):
    if data.dim() <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("identity", aliases=("_copy", "copy"))
def identity(data):
    return data  # the NDArray layer copies a result that aliases its input


@register("stop_gradient", aliases=("BlockGrad", "block_grad"))
def stop_gradient(data):
    return data.detach()


@register("depth_to_space")
def depth_to_space(data, block_size=2):
    b = block_size
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=2):
    b = block_size
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("_sym_index")
def _sym_index(data, index_spec=None):
    """Decode the JSON index spec a Symbol's ``__getitem__`` encodes
    (symbolic indexing: pos_table[:T], seq[:, 0, :], ...)."""
    idx = []
    for item in index_spec or []:
        tag = item[0]
        if tag == "i":
            idx.append(int(item[1]))
        elif tag == "s":
            idx.append(builtins.slice(item[1], item[2], item[3]))
        elif tag == "e":
            idx.append(Ellipsis)
        else:
            idx.append(None)
    return data[tuple(idx)]
