"""Control-flow ops: ``foreach``, ``while_loop`` and ``cond``.

Counterpart of ``mxnet_tpu/ops/control_flow.py`` (reference:
src/operator/control_flow.cc and python/mxnet/ndarray/contrib.py).  The
JAX package maps them onto ``lax.scan``, ``lax.while_loop`` and
``lax.cond``; here they are Python loops and branches over the body's own
ops, so they take NDArrays or tensors, and autograd records the steps as
it records any op.

A tensor predicate (``while_loop``'s ``cond``, ``cond``'s ``pred``) is
read to the host at each test: a sync point on the card, which a CUDA
graph cannot capture.
"""

from __future__ import annotations

import torch


def _nd():
    from ..ndarray import ndarray

    return ndarray.NDArray


def _truth(v):
    """A predicate's value on the host (a device read for a tensor)."""
    if isinstance(v, _nd()):
        v = v._data
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(()).item())
    return bool(v)


def _stack(items):
    if isinstance(items[0], _nd()):
        from .. import ndarray as nd

        return nd.stack(*items, axis=0)
    return torch.stack(items, dim=0)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def foreach(body, data, init_states):
    """Run ``body(step_data, states) -> (outputs, new_states)`` over the
    leading axis of ``data`` (an array or a list of arrays); returns
    (the outputs stacked along a new leading axis, the final states)."""
    seq = _as_list(data)
    states = init_states
    outs = []
    for i in range(seq[0].shape[0]):
        step = [d[i] for d in seq]
        out, states = body(step if isinstance(data, (list, tuple))
                           else step[0], states)
        outs.append(out)
    if isinstance(outs[0], (list, tuple)):
        stacked = [_stack([o[j] for o in outs])
                   for j in range(len(outs[0]))]
    else:
        stacked = _stack(outs)
    return stacked, states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func(*loop_vars) -> (step_output, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times.

    Without ``max_iterations`` the outputs are dropped: returns ([], the
    final loop vars).  With it, each output is stacked into a buffer of
    ``max_iterations`` rows, zeros past the steps run (the JAX package's
    static shape); the count is recoverable from the loop vars.  ``cond``
    is read to the host before every step."""
    vs = list(loop_vars)
    outs = []
    single = None
    while (max_iterations is None or len(outs) < max_iterations) and \
            _truth(cond(*vs)):
        out, new_vs = func(*vs)
        vs = _as_list(new_vs)
        if max_iterations is not None:
            single = not isinstance(out, (list, tuple))
            outs.append(_as_list(out))
    if max_iterations is None:
        return [], vs
    if not outs:
        # no step ran: one probe step gives the outputs' shapes and dtypes
        probe, _ = func(*vs)
        single = not isinstance(probe, (list, tuple))
        bufs = [_zeros_like_rows(p, max_iterations) for p in
                _as_list(probe)]
    else:
        bufs = []
        for j in range(len(outs[0])):
            rows = _stack([o[j] for o in outs])
            pad = max_iterations - len(outs)
            if pad:
                rows = _concat(rows, _zeros_like_rows(outs[0][j], pad))
            bufs.append(rows)
    return (bufs[0] if single else bufs), vs


def _zeros_like_rows(x, n):
    if isinstance(x, _nd()):
        from .. import ndarray as nd

        return nd.zeros((n,) + x.shape, ctx=x.context,
                        dtype=x._data.dtype)
    return torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


def _concat(a, b):
    if isinstance(a, _nd()):
        from .. import ndarray as nd

        return nd.concat(a, b, dim=0)
    return torch.cat([a, b], dim=0)


def cond(pred, then_func, else_func, inputs=None):
    """``then_func()`` if ``pred`` holds, else ``else_func()`` (each called
    with ``*inputs`` when given); ``pred`` is read to the host."""
    branch = then_func if _truth(pred) else else_func
    return branch() if inputs is None else branch(*inputs)
