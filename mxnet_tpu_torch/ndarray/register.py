"""Generated NDArray op wrappers and the eager invoke path.

Counterpart of ``mxnet_tpu/ndarray/register.py:49-58,104-289``
(python/mxnet/ndarray/register.py's codegen and
src/imperative/imperative.cc Imperative::Invoke).  The wrapper is
polymorphic:

- NDArray inputs: the eager path.  Unwrap, run the pure op on the tensors
  (grad enabled only inside ``autograd.record()``, so torch's autograd is
  the tape), wrap the outputs.  An output that shares storage with an
  input is copied, so no two NDArrays share a buffer (``ndarray.py``).
- raw tensors: pure pass-through, which Gluon's ``F`` namespace uses
  (``gluon.block.HybridBlock``).

Before the generic unwrap, the storage dispatch (the reference's
FComputeEx, ``mxnet_tpu/ndarray/register.py:61-110``) routes the ops that
have a compact kernel: ``dot`` with a CSR left operand, ``Cast_storage``,
and add and multiply of two row-sparse operands off the tape.  While
``mx.profiler`` runs, each op runs inside ``profiler.op_span(name)`` (an
``operator`` event in the Chrome trace), and under the profiler's sync
mode the span blocks on the result before it closes.
"""

from __future__ import annotations

import torch

from .. import autograd as _ag
from .. import engine
from .. import profiler as _prof
from ..base import MXNetError
from ..ops import registry as _registry
from ..ops.registry import OpDef
from .ndarray import NDArray


def _device_of(args, kwargs, req_ctx):
    if req_ctx is not None:
        return req_ctx.device
    for a in (*args, *kwargs.values()):
        if isinstance(a, NDArray):
            return a._data.device
        if isinstance(a, torch.Tensor):
            return a.device
    from ..context import current_context

    return current_context().device


def _inject(opdef: OpDef, args, kwargs: dict, req_ctx) -> dict:
    if opdef.mode_dependent and kwargs.get("_is_training") is None:
        kwargs = dict(kwargs)
        kwargs["_is_training"] = _ag.is_training()
    if opdef.random and kwargs.get("_key") is None:
        from ..random import current_generator

        kwargs = dict(kwargs)
        kwargs["_key"] = current_generator(_device_of(args, kwargs, req_ctx))
    return kwargs


def _stype_dispatch(opdef, args, kwargs):
    """The compact result of an op with a sparse kernel for these
    operands, or None (the dense path)."""
    if not args or not isinstance(args[0], NDArray):
        return None
    from . import sparse

    if opdef.name == "dot":
        if isinstance(args[0], sparse.CSRNDArray):
            # transpose flags may come positionally, in the dense op's order
            extras = args[2:4]
            ta = extras[0] if len(extras) > 0 else kwargs.get(
                "transpose_a", False)
            tb = extras[1] if len(extras) > 1 else kwargs.get(
                "transpose_b", False)
            return sparse.dot(args[0], args[1], transpose_a=ta,
                              transpose_b=tb)
    elif opdef.name.lower() == "cast_storage":
        stype = kwargs.get("stype", args[1] if len(args) > 1 else "default")
        return sparse.cast_storage(args[0], stype)
    elif opdef.name in ("elemwise_add", "broadcast_add", "add",
                        "elemwise_mul", "broadcast_mul", "multiply") \
            and len(args) >= 2:
        if isinstance(args[0], sparse.RowSparseNDArray) and \
                isinstance(args[1], sparse.RowSparseNDArray) and \
                not sparse._on_eager_tape(args[0], args[1]):
            fn = sparse.add if "add" in opdef.name else sparse.elemwise_mul
            return fn(args[0], args[1])
    return None


def invoke(opdef: OpDef, args: tuple, kwargs: dict):
    # frontend-only kwargs accepted by every reference op wrapper
    out_arr = kwargs.pop("out", None)
    req_ctx = kwargs.pop("ctx", None)
    kwargs.pop("name", None)  # symbol-compat: ignored eagerly
    sparse_out = _stype_dispatch(opdef, args, kwargs)
    if sparse_out is not None:
        if out_arr is not None or req_ctx is not None:
            from .sparse import BaseSparseNDArray

            if isinstance(sparse_out, BaseSparseNDArray):
                raise MXNetError(f"{opdef.name}: out=/ctx= unsupported when "
                                 "the result has sparse storage")
            return _finalize(sparse_out, out_arr, req_ctx)
        return sparse_out
    kwargs = _inject(opdef, args, kwargs, req_ctx)
    if _prof._S.running:  # cheap flag read on the hot path
        with _prof.op_span(opdef.name):
            result = _invoke_inner(opdef, args, kwargs)
            if _prof.want_sync():
                _block_result(result)
    else:
        result = _invoke_inner(opdef, args, kwargs)
    if out_arr is not None or req_ctx is not None:
        return _finalize(result, out_arr, req_ctx)
    return result


def _block_result(result):
    """Wait for an op's outputs (the profiler's sync mode: the span then
    covers the device work, not just the launch)."""
    items = result if isinstance(result, (tuple, list)) else (result,)
    for r in items:
        if isinstance(r, NDArray):
            r.wait_to_read()


def _finalize(result, out_arr, req_ctx):
    if req_ctx is not None and isinstance(result, NDArray):
        result = result.as_in_context(req_ctx)
    if out_arr is not None:
        src = result[0] if isinstance(result, tuple) else result
        if isinstance(src, NDArray):
            out_arr._adopt(src)
        else:
            out_arr._set_data(src)
        return out_arr
    return result


def _invoke_inner(opdef: OpDef, args: tuple, kwargs: dict):
    fn = opdef.fn
    if opdef.opaque:
        return fn(*args, **kwargs)  # host-level op: handles NDArrays itself

    slots = [i for i, a in enumerate(args) if isinstance(a, NDArray)]
    kslots = [k for k, v in kwargs.items() if isinstance(v, NDArray)]
    if not slots and not kslots:
        if any(isinstance(a, torch.Tensor) for a in args) or any(
                isinstance(v, torch.Tensor) for k, v in kwargs.items()
                if not k.startswith("_")):
            return fn(*args, **kwargs)          # raw tensors: pass through
        # creation-style op called eagerly (no array inputs): wrap output
        with torch.no_grad():
            out = fn(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            return tuple(_wrap(o, None, ()) for o in out)
        return _wrap(out, None, ())

    a2, k2 = list(args), dict(kwargs)
    for i in slots:
        a2[i] = args[i]._data
    for k in kslots:
        k2[k] = kwargs[k]._data
    inputs = [a2[i] for i in slots] + [k2[k] for k in kslots]
    ctx = (args[slots[0]] if slots else kwargs[kslots[0]])._ctx
    with torch.set_grad_enabled(_ag.is_recording()):
        out = fn(*a2, **k2)
        if isinstance(out, (tuple, list)):
            return tuple(_wrap(o, ctx, inputs) for o in out)
        return _wrap(out, ctx, inputs)


def _storage(t):
    return t.untyped_storage().data_ptr()


def _wrap(o, ctx, inputs):
    """Wrap an op's tensor output; copy it first when it shares storage
    with an input (one owner per buffer)."""
    if not isinstance(o, torch.Tensor):
        return o
    if inputs and o.numel():
        ptr = _storage(o)
        if any(isinstance(t, torch.Tensor) and t.numel() and
               _storage(t) == ptr for t in inputs):
            o = o.clone()
    return NDArray(engine.maybe_sync(o), ctx)


def invoke_registered(name: str, args: tuple, kwargs: dict):
    return invoke(_registry.get(name), args, kwargs)


def invoke_simple(fn, args: tuple, kwargs: dict | None = None, name=""):
    """Invoke an unregistered pure function with full NDArray/autograd
    handling (indexing and other ad-hoc dunder ops)."""
    return invoke(OpDef(name or getattr(fn, "__name__", "fn"), fn),
                  args, dict(kwargs or {}))


def _make_wrapper(opdef: OpDef):
    def wrapper(*args, **kwargs):
        return invoke(opdef, args, kwargs)

    wrapper.__name__ = opdef.name
    wrapper.__qualname__ = opdef.name
    wrapper.__doc__ = (opdef.fn.__doc__ or "") + \
        f"\n\n(generated NDArray wrapper for op '{opdef.name}')"
    return wrapper


def populate(namespace: dict, names=None):
    """Generate wrappers for every registered op into ``namespace``
    (reference: _init_ops in python/mxnet/ndarray/register.py)."""
    for name, opdef in _registry.all_ops().items():
        if names is not None and name not in names:
            continue
        if name not in namespace:
            namespace[name] = _make_wrapper(opdef)


# NDArray instance methods generated from ops (mx.nd.NDArray method
# surface); those whose op family is not ported yet are skipped.
_METHOD_OPS = [
    "sum", "mean", "prod", "max", "min", "argmax", "argmin", "norm",
    "transpose", "flatten", "expand_dims", "squeeze", "clip", "abs",
    "exp", "log", "sqrt", "square", "sigmoid", "tanh", "relu", "softmax",
    "log_softmax", "slice_axis", "take", "flip", "tile", "repeat", "pad",
    "round", "floor", "ceil", "split", "one_hot", "topk", "sort", "argsort",
    "swapaxes", "broadcast_to", "broadcast_like", "slice_like", "sign",
    "zeros_like", "ones_like", "stop_gradient", "diag", "cumsum",
]


def _attach_methods():
    for name in _METHOD_OPS:
        if name in _registry.all_ops() and not hasattr(NDArray, name):
            opdef = _registry.get(name)

            def method(self, *a, _opdef=opdef, **kw):
                return invoke(_opdef, (self,) + a, kw)

            method.__name__ = name
            setattr(NDArray, name, method)


_attach_methods()
