"""The graph executor: ``forward``/``backward`` over a bound Symbol.

Counterpart of ``mxnet_tpu/symbol/executor.py:18-147`` (reference:
src/executor/graph_executor.cc and python/mxnet/executor.py):
``arg_dict``/``grad_dict``/``aux_dict`` and their ``*_arrays`` lists,
``forward(is_train)``, ``backward(out_grads)`` under ``grad_req``
``write``/``add``/``null``, ``outputs``, ``copy_params_from`` and
``reshape``.

The JAX Executor rebuilds the forward inside ``jax.grad`` at
``backward``.  Here a training forward runs the graph op by op under
torch's autograd, with the arguments that take gradients as fresh leaves,
and ``backward`` differentiates that recording: the backward sees the
forward's own dropout masks and BatchNorm batch statistics.  A forward in
predict mode records nothing; a ``backward`` after it runs the forward
again, recorded, in the same mode.  Auxiliary states (BatchNorm's moving
statistics) are updated in place by a training forward.  While a
``Monitor`` is installed the forward keeps every node's output for it.
"""

from __future__ import annotations

import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..ndarray.ndarray import NDArray


def _tensor(v, like):
    raw = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
    return raw.to(device=like.device, dtype=like.dtype)


def _assign(arr, value):
    """Write ``value`` into the bound array ``arr``: in place when the
    shapes match (the array's storage is kept, shared or not), else as a
    new value of the array's dtype on its device."""
    t = _tensor(value, arr._data)
    if tuple(t.shape) == tuple(arr.shape):
        with torch.no_grad():
            arr._data.copy_(t)
        arr._version += 1
    else:
        arr._set_data(t.clone())


class Executor:
    def __init__(self, symbol, args, args_grad=None, grad_req="write",
                 aux_states=None, ctx=None):
        self._symbol = symbol
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_dict = dict(args) if args else {}
        for name in self._arg_names:
            if name not in self.arg_dict:
                raise MXNetError(f"missing argument {name} in bind")
        self.arg_arrays = [self.arg_dict[n] for n in self._arg_names]
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = {n: grad_req.get(n, "null")
                          for n in self._arg_names}
        if args_grad is None:
            args_grad = {n: NDArray(torch.zeros_like(self.arg_dict[n]._data),
                                    self.arg_dict[n]._ctx)
                         for n in self._arg_names
                         if self._grad_req[n] != "null"}
        elif isinstance(args_grad, (list, tuple)):
            args_grad = {n: g for n, g in zip(self._arg_names, args_grad)
                         if g is not None}
        self.grad_dict = dict(args_grad)
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self._aux_names, aux_states))
        self.aux_dict = dict(aux_states) if aux_states else {}
        self.aux_arrays = [self.aux_dict[n] for n in self._aux_names
                           if n in self.aux_dict]
        self._ctx = ctx or (self.arg_arrays[0]._ctx if self.arg_arrays
                            else None)
        self.outputs = []
        self._recorded = None      # (output tensors, {name: leaf})
        self._last_is_train = False
        self._monitors = []
        self._node_values = None

    def _grad_names(self):
        return [n for n in self._arg_names if self._grad_req[n] != "null"]

    def _run(self, is_train, record):
        env = {n: a._data for n, a in self.arg_dict.items()}
        env.update({n: a._data for n, a in self.aux_dict.items()})
        leaves = {}
        if record:
            for n in self._grad_names():
                leaves[n] = env[n] = env[n].detach().requires_grad_(True)
        cache = {}
        mode = _ag.train_mode() if is_train else _ag.predict_mode()
        with mode, torch.set_grad_enabled(record):
            outs = self._symbol._eval_heads(env, cache)
        self._recorded = (outs, leaves) if record else None
        self._node_values = cache if self._monitors else None
        self._last_is_train = bool(is_train)
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]

    def forward(self, is_train=False, **kwargs):
        """Write ``kwargs`` into the bound arguments, then run the graph;
        a training forward records it for ``backward``."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                _assign(self.arg_dict[k], v)
        self._run(is_train, bool(is_train) and bool(self._grad_names()))
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs (weighted by ``out_grads``, default
        ones) into ``grad_dict``, written or added per ``grad_req``."""
        if not self.outputs:
            raise MXNetError("call forward before backward")
        if not self._grad_names():
            return
        if self._recorded is None:
            self._run(self._last_is_train, True)
        outs, leaves = self._recorded
        self._recorded = None       # the recording is spent by this pass
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            heads = [_tensor(g, o) for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                grad_outputs=[h for _, h in pairs], allow_unused=True)
        for n, g in zip(names, grads):
            tgt = self.grad_dict.get(n)
            if tgt is None:
                continue
            g = torch.zeros_like(leaves[n]) if g is None else g
            if g.is_sparse:
                g = g.to_dense()
            g = g.to(tgt._data.dtype)
            if self._grad_req[n] == "add":
                tgt._set_data(tgt._data + g)
            else:
                tgt._set_data(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays, in their dtypes."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                _assign(self.arg_dict[name], array)
            elif not allow_extra_params:
                raise ValueError(f"Found name '{name}' that is not in the "
                                 "arguments")
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                _assign(self.aux_dict[name], array)
            elif not allow_extra_params:
                raise ValueError(f"Found name '{name}' that is not in the "
                                 "auxiliary states")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """An executor for new input shapes: arrays whose shapes do not
        change are this executor's own (shared storage), the others new
        zero arrays."""
        def fresh(arr, shape):
            if tuple(shape) == tuple(arr.shape):
                return arr
            return NDArray(torch.zeros(shape, dtype=arr._data.dtype,
                                       device=arr._data.device), arr._ctx)

        args = {n: fresh(a, kwargs.get(n, a.shape))
                for n, a in self.arg_dict.items()}
        return Executor(self._symbol, args, grad_req=self._grad_req,
                        aux_states=self.aux_dict, ctx=self._ctx)
