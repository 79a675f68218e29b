"""The NDArray: MXNet's array semantics over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  The JAX NDArray has
value semantics: each array owns an immutable buffer, and mutation swaps
the handle.  Torch shares storage (basic slicing, ``detach`` and
``reshape`` return views), so the port keeps two rules that give the JAX
package's results:

- **Handle swap.** Every mutation route (``x[key] = v``, ``+=``,
  ``out=``, ``copyto``) computes a new tensor and swaps ``self._data``,
  bumping ``_version``; no tensor another array can see is written.
- **One owner per storage.** An op whose result shares storage with one
  of its inputs (a view: reshape, slice, transpose, detach ...) gets a
  copy (``register._wrap``).  So no two NDArrays share a buffer, and the
  one route that writes a buffer in place, a runtime-compiled kernel's
  non-const pointer (``rtc.CudaKernel.launch``), changes that array and
  no other.

Autograd rides on ``torch.autograd`` (see ``autograd.py``): an array with
``grad_req != 'null'`` holds a leaf tensor that requires grad; ops inside
``autograd.record()`` run with grad enabled, outside it under
``torch.no_grad()``.  Work is asynchronous on the CUDA stream;
``wait_to_read`` synchronises, and a device fault surfaces there.
"""

from __future__ import annotations

import weakref

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, context_of
from .. import engine


class NDArray:
    __slots__ = ("_data", "_ctx", "_version", "_grad", "_grad_req",
                 "_leaf", "_fresh_grad", "__weakref__")

    # make NumPy defer to NDArray dunders (mx.nd semantics)
    __array_priority__ = 100.0

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx
        self._version = 0
        self._grad = None
        self._grad_req = "null"
        self._leaf = None   # the tensor autograd differentiates against
        self._fresh_grad = False    # set by backward, cleared by a Trainer

    # -- basic properties ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def stype(self):
        return "default"

    @property
    def context(self):
        return self._ctx if self._ctx is not None \
            else context_of(self._data.device)

    ctx = context

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    @property
    def handle(self):  # reference-compat attribute
        return self._data

    @property
    def version(self):
        return self._version

    def _on_tape(self):
        return self._grad_req != "null" or self._data.grad_fn is not None

    # -- sync / host transfer --------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A host copy, never a view of the array's tensor (a Gluon
        parameter's tensor is updated in place); bfloat16 comes back as
        float32 (numpy has no bfloat16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    # -- device movement -------------------------------------------------------
    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        dev = ctx.device
        out = self._apply(lambda d: d.to(dev), name="as_in_context")
        out._ctx = ctx
        return out

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.device, copy=True),
                           other)
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        raise MXNetError(f"cannot copyto {type(other)}")

    def copy(self):
        return NDArray(self._data.detach().clone(), self._ctx)

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        return self._apply(lambda d: d.to(dt), name="astype")

    # -- autograd --------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array a variable; ``stype="row_sparse"`` gives it a
        compact gradient buffer (O(touched rows) after ``backward``)."""
        if stype == "row_sparse":
            from .sparse import zeros as sparse_zeros

            self._grad = sparse_zeros("row_sparse", self.shape, self._ctx
                                      or self.context, self._data.dtype)
        elif stype in (None, "default"):
            self._grad = NDArray(torch.zeros_like(self._data.detach()),
                                 self._ctx)
        else:
            raise MXNetError(f"attach_grad(stype={stype!r}): gradients "
                             "are dense or row_sparse")
        self._grad_req = grad_req
        self._make_leaf(self._data)

    def _make_leaf(self, t):
        """Make ``t`` this variable's data: a fresh leaf tensor that
        requires grad (floating types only), linked back to this array."""
        t = t.detach()
        if t.is_floating_point():
            t.requires_grad_(True)
        t._mx_var = weakref.ref(self)
        self._data = self._leaf = t

    def detach(self):
        return NDArray(self._data.detach().clone(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None else
                          None, retain_graph, train_mode)

    # -- op plumbing -----------------------------------------------------------
    def _apply(self, fn, *others, name=""):
        """Run fn over the raw tensors (self first), recorded while
        autograd records."""
        from .register import invoke_simple

        return invoke_simple(fn, (self,) + others, name=name)

    # -- mutation (handle swap) ------------------------------------------------
    def _set_data(self, t):
        """Swap in ``t`` as this array's value.  A variable mutated
        outside ``record()`` takes ``t`` as its new leaf; inside, ``t``
        stays on the graph and gradients still reach the old leaf."""
        from .. import autograd

        t = engine.maybe_sync(t)
        if self._grad_req != "null" and not autograd.is_recording():
            self._make_leaf(t)
        else:
            self._data = t
        self._version += 1

    def __setitem__(self, key, value):
        from .. import autograd

        key = _unwrap_index(key)
        if isinstance(key, tuple) and len(key) == 0:
            key = Ellipsis
        with torch.set_grad_enabled(autograd.is_recording()):
            new = self._data.clone()
            if isinstance(value, NDArray):
                value = value._data
            if isinstance(value, torch.Tensor):
                value = value.to(device=new.device, dtype=new.dtype)
            elif isinstance(value, _np.ndarray):
                value = torch.as_tensor(value, dtype=new.dtype,
                                        device=new.device)
            new[key] = value
        self._set_data(new)

    def __getitem__(self, key):
        key2 = _unwrap_index(key)
        return self._apply(lambda d: d[key2], name="getitem")

    # -- python protocol -------------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {'x'.join(map(str, self.shape))}" \
               f" @{self.context}>"

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, **kwargs):
        return self._data.detach().__dlpack__(**kwargs)

    # pickle via host numpy, onto the current context at load
    def __reduce__(self):
        return (_unpickle_ndarray, (self.asnumpy(),
                                    str(self._data.dtype).split(".")[1]))

    # NDArray equality is elementwise (reference semantics) -> unhashable.
    __hash__ = None  # type: ignore

    # -- arithmetic ------------------------------------------------------------
    def _binop(self, other, opname, reverse=False):
        from .register import invoke_registered

        if isinstance(other, _np.ndarray):
            other = NDArray(torch.as_tensor(other, device=self._data.device))
        a, b = (other, self) if reverse else (self, other)
        return invoke_registered(opname, (a, b), {})

    def __add__(self, o):
        return self._binop(o, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", reverse=True)

    def __matmul__(self, o):
        return self._binop(o, "dot")

    def __neg__(self):
        return self._apply(lambda d: -d, name="negative")

    def __abs__(self):
        return self._apply(torch.abs, name="abs")

    def __eq__(self, o):
        return self._binop(o, "broadcast_equal")

    def __ne__(self, o):
        return self._binop(o, "broadcast_not_equal")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal")

    # in-place: handle swap (see module docstring)
    def _adopt(self, out):
        """Take over ``out``'s value (in-place semantics); inside
        ``record()`` this array now carries ``out``'s place on the
        graph."""
        self._set_data(out._data)
        return self

    def _ibinop(self, other, opname):
        return self._adopt(self._binop(other, opname))

    def __iadd__(self, o):
        return self._ibinop(o, "broadcast_add")

    def __isub__(self, o):
        return self._ibinop(o, "broadcast_sub")

    def __imul__(self, o):
        return self._ibinop(o, "broadcast_mul")

    def __itruediv__(self, o):
        return self._ibinop(o, "broadcast_div")

    def tostype(self, stype):
        """A copy in storage ``stype``: 'default', 'row_sparse' or
        'csr'."""
        if stype == "default":
            return self.copy()
        from .sparse import cast_storage

        return cast_storage(self, stype)

    # reshape takes reshape(2,3), reshape((2,3)) and the special codes
    def reshape(self, *shape, **kwargs):
        from .register import invoke_registered

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = kwargs.pop("shape")
        return invoke_registered("reshape", (self,),
                                 {"shape": shape, **kwargs})

    def reshape_like(self, other):
        from .register import invoke_registered

        return invoke_registered("reshape_like", (self, other), {})


def _unwrap_index(key):
    """NDArray indices become tensors: floating ones cast to int64 (the
    JAX package casts them to int32), integer ones widened to int64."""
    if isinstance(key, NDArray):
        k = key._data.detach()
        return k if k.dtype == torch.bool else k.long()
    if isinstance(key, tuple):
        return tuple(_unwrap_index(k) for k in key)
    return key


def _unpickle_ndarray(np_data, dtype_name):
    from .. import context

    t = torch.as_tensor(np_data).to(torch_dtype(dtype_name))
    return NDArray(t.to(context.current_context().device))


#: the JAX package places host arrays in jax's 32-bit mode, so a 64-bit
#: host array arrives on the device as its 32-bit counterpart; the input
#: path (DataLoader, io, image) delivers the same dtypes
_HOST_32 = {_np.dtype(_np.float64): _np.dtype(_np.float32),
            _np.dtype(_np.int64): _np.dtype(_np.int32),
            _np.dtype(_np.uint64): _np.dtype(_np.uint32),
            _np.dtype(_np.complex128): _np.dtype(_np.complex64)}


def host_dtype(dtype):
    """The numpy dtype a host array of ``dtype`` is delivered in."""
    dtype = _np.dtype(dtype)
    return _HOST_32.get(dtype, dtype)


def from_host(arr, ctx=None, own=False):
    """A host array (numpy, or a CPU tensor) as an NDArray on ``ctx``
    (default ``current_context()``), in ``host_dtype``: one copy to the
    card, or on the host one copy unless ``own`` says the caller hands
    over a buffer nothing else holds."""
    from ..context import current_context

    ctx = ctx or current_context()
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        arr = _np.asarray(arr)
        want = host_dtype(arr.dtype)
        if want != arr.dtype:
            arr, own = arr.astype(want), True
        if not arr.flags.writeable or any(st < 0 for st in arr.strides):
            arr, own = arr.copy(), True
        t = torch.from_numpy(arr)
    if ctx.device_type == "cpu":
        return NDArray(t if own else t.clone(), ctx)
    return NDArray(t.to(ctx.device), ctx)
