"""Custom operators: ``mx.operator.CustomOp``, ``CustomOpProp``,
``register`` and ``get``.

Counterpart of ``mxnet_tpu/operator.py`` (reference:
src/operator/custom/custom.cc and python/mxnet/operator.py): user ops
written as Python callbacks on NDArrays, invoked as ``mx.nd.Custom(...,
op_type=name)``.  The forward runs off the tape; under
``autograd.record()`` the op joins torch's tape through the port's
``autograd.Function``, whose backward calls the op's ``backward``.  A
callback runs eagerly, op by op, on whatever device its arrays live on.
"""

from __future__ import annotations

from .base import MXNetError

_CUSTOM_OPS: dict = {}


class CustomOp:
    """Base of a custom op's implementation (forward/backward on
    NDArrays)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says: "write"/"inplace"
        replace, "add" accumulates, "null" does nothing."""
        raw = src._data if hasattr(src, "_data") else src
        if req in ("write", "inplace", None):
            dst._set_data(raw)
        elif req == "add":
            dst._set_data(dst._data + raw)


class CustomOpProp:
    """A custom op's shapes, types and argument names."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Decorator: ``@mx.operator.register("myop")`` on a ``CustomOpProp``
    subclass."""

    def _do(prop_cls):
        _CUSTOM_OPS[reg_name] = prop_cls
        return prop_cls

    return _do


def get(name):
    if name not in _CUSTOM_OPS:
        raise MXNetError(f"custom_op {name!r} is not registered")
    return _CUSTOM_OPS[name]


def _invoke_custom(op_type, data, kwargs):
    """The body of the registered op ``Custom`` (``ops/nn.py``)."""
    from . import autograd
    from . import ndarray as nd
    from .context import context_of
    from .ndarray.ndarray import NDArray

    if op_type is None or op_type not in _CUSTOM_OPS:
        raise MXNetError(
            f"Custom op_type {op_type!r} is not registered; use "
            "@mx.operator.register(name) on a CustomOpProp subclass")
    prop_cls = _CUSTOM_OPS[op_type]
    prop = prop_cls(**kwargs) if kwargs else prop_cls()

    inputs = [d if isinstance(d, NDArray) else NDArray(d, context_of(
        d.device)) for d in data]
    ctx = inputs[0].context
    in_shapes = [list(i.shape) for i in inputs]
    in_shapes, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    op = prop.create_operator(ctx, in_shapes, [i.dtype for i in inputs])

    out_data = [nd.zeros(tuple(s), ctx=ctx) for s in out_shapes]
    aux = [nd.zeros(tuple(s), ctx=ctx) for s in aux_shapes]

    class _Fn(autograd.Function):
        def forward(self, *ins):
            op.forward(autograd.is_training(), ["write"] * len(out_data),
                       list(ins), out_data, aux)
            self.save_for_backward(list(ins), out_data)
            return tuple(out_data) if len(out_data) > 1 else out_data[0]

        def backward(self, *ograds):
            ins, outs = self._saved
            in_grad = [nd.zeros(i.shape, ctx=ctx) for i in ins]
            op.backward(["write"] * len(in_grad), list(ograds), ins, outs,
                        in_grad, aux)
            return tuple(in_grad) if len(in_grad) > 1 else in_grad[0]

    return _Fn()(*inputs)
