"""Autograd: MXNet's imperative API on ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py`` (reference: python/mxnet/
autograd.py and src/imperative/imperative.cc Imperative::Backward).
Torch's graph is the tape: ops inside ``record()`` run with grad enabled,
outside it (and inside ``pause()``) under ``torch.no_grad()``.  A
variable (``attach_grad``/``mark_variables``) holds a leaf tensor that
requires grad and points back to its NDArray.  MXNet's semantics, where
they differ from torch's, are kept here:

- ``backward`` computes the gradients of every variable the heads reach
  with ``torch.autograd.grad`` and applies each once, per its
  ``grad_req`` (``write`` replaces, ``add`` accumulates); torch's own
  ``.grad`` is never used;
- a non-scalar head is seeded with ones;
- the heads leave the tape unless ``retain_graph``;
- a head off the tape that is a variable gets ones (or its head grad); a
  head off the tape that is not raises ``MXNetError``;
- ``Function`` becomes a ``torch.autograd.Function`` that calls the
  user's NDArray ``forward``/``backward`` under ``pause()``;
- a row-sparse gradient (``ops.indexing.sparse_embedding``'s) travels
  the tape as a sparse COO tensor, summing with another by
  concatenation; a dense term makes the sum dense, as the reference's
  ``_RowSparseCt.__add__`` does.  It reaches a ``RowSparseNDArray``
  gradient buffer compactly (coalesced, concatenated with the stored
  rows first under ``grad_req='add'``), and a dense buffer as a scatter
  of its rows.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AGState()


# -- scope management ----------------------------------------------------------

class _RecordingScope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev


def record(train_mode=True):
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, flag
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, flag
    return prev


def mark_variables(variables, gradients, grad_reqs="write"):
    """Reference: MXAutogradMarkVariables."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        v._make_leaf(v._data)


@contextlib.contextmanager
def accumulate_grads(params):
    """Accumulate gradients over several ``backward()`` calls: the eager
    side of gradient accumulation (``Trainer.train_step``'s oracle for
    ``grad_accum > 1``).  Zeroes each trainable Parameter's gradient,
    switches its ``grad_req`` to 'add' for the scope and restores it on
    exit without touching the summed gradient, so the first microbatch
    computes ``0 + g``, as the captured step's zero-initialised sum
    does."""
    params = [p for p in params if p.grad_req != "null"]
    saved = [(p, p.grad_req) for p in params]
    for p in params:
        p.zero_grad()
        p._grad_req = "add"
        if p._nd is not None:
            p._nd._grad_req = "add"
    try:
        yield
    finally:
        for p, req in saved:
            p._grad_req = req
            if p._nd is not None:
                p._nd._grad_req = req


# -- backward ------------------------------------------------------------------

def _as_list(heads, head_grads):
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads, list):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    return list(heads), list(head_grads)


def _seed(h, hg):
    if hg is None:
        return torch.ones_like(h._data)
    return hg._data.detach().to(dtype=h._data.dtype, device=h._data.device)


def _reached_variables(grad_fns):
    """Variables (NDArrays) whose leaf tensors the graphs behind
    ``grad_fns`` reach, in first-seen order."""
    found, seen, stack = {}, set(), list(grad_fns)
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        leaf = getattr(fn, "variable", None)
        if leaf is not None:
            ref = getattr(leaf, "_mx_var", None)
            var = ref() if ref is not None else None
            if var is not None and var._leaf is leaf:
                found.setdefault(id(var), var)
            continue
        stack.extend(f for f, _ in fn.next_functions)
    return list(found.values())


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Compute the gradients of ``heads`` with respect to every variable
    they reach and apply them per ``grad_req`` (reference:
    Imperative::Backward)."""
    heads, head_grads = _as_list(heads, head_grads)
    accum: dict[int, list] = {}          # id(var) -> [var, summed grad]
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if h._data.grad_fn is None:
            if h._grad_req != "null":
                _accum(accum, h, _seed(h, hg))
                continue
            raise MXNetError(
                "cannot differentiate a head that is not on the tape; "
                "call backward inside/after autograd.record()")
        outs.append(h._data)
        seeds.append(_seed(h, hg))
    if outs:
        with _RecordingScope(False, train_mode):
            variables = [v for v in _reached_variables(
                [o.grad_fn for o in outs]) if v._grad_req != "null"
                and v._grad is not None]
            grads = torch.autograd.grad(
                outs, [v._leaf for v in variables], seeds,
                retain_graph=bool(retain_graph), allow_unused=True)
        for v, g in zip(variables, grads):
            if g is not None:
                _accum(accum, v, g)
        if not retain_graph:
            for h in heads:
                if h._data.grad_fn is not None:
                    h._data = h._data.detach()
    seed_ptrs = {s.untyped_storage().data_ptr() for s in seeds if s.numel()}
    for var, g in accum.values():
        _apply_grad(var, g, seed_ptrs)


def _accum(accum, var, g):
    entry = accum.get(id(var))
    if entry is None:
        accum[id(var)] = [var, g]
    elif entry[1].is_sparse and not g.is_sparse:
        entry[1] = g + entry[1]
    else:
        entry[1] = entry[1] + g


def _apply_sparse_grad(var, g):
    """Write a row-sparse cotangent (sparse COO) into ``var``'s gradient
    buffer, O(touched rows) for a row-sparse buffer."""
    from .ndarray.sparse import RowSparseNDArray, coalesce

    grad = var._grad
    idx, vals = g._indices()[0], g._values().detach()
    if isinstance(grad, RowSparseNDArray):
        vals = vals.to(grad._rs_values.dtype)
        coalesced = g.is_coalesced()
        if var._grad_req == "add" and grad.num_stored_rows:
            idx = torch.cat([idx, grad._rs_indices])
            vals = torch.cat([vals, grad._rs_values])
            coalesced = False
        if not coalesced:
            idx, vals = coalesce(idx, vals)
        grad._set_sparse(idx, vals)
    else:
        vals = vals.to(grad._data.dtype)
        base = grad._data if var._grad_req == "add" \
            else torch.zeros_like(grad._data)
        grad._data = base.index_put((idx,), vals, accumulate=True)
        grad._version += 1
    var._fresh_grad = True


def _apply_grad(var, g, seed_ptrs):
    if g.is_sparse:
        _apply_sparse_grad(var, g)
        return
    grad = var._grad
    g = g.detach()
    if getattr(grad, "stype", "default") == "row_sparse":
        if var._grad_req == "add":
            g = grad._data + g.to(grad._rs_values.dtype)
        grad._set_data(g)       # a dense gradient, kept as its nonzero rows
        var._fresh_grad = True
        return
    g = g.to(grad._data.dtype)
    if g.numel() and g.untyped_storage().data_ptr() in seed_ptrs:
        g = g.clone()   # a head grad passed straight through: own a copy
    if var._grad_req == "add":
        g = grad._data + g
    grad._data = g
    grad._version += 1
    var._fresh_grad = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Reference: mx.autograd.grad.  Returns the gradients of ``heads``
    with respect to ``variables`` without touching their ``.grad``
    buffers.  With ``create_graph`` the returned arrays are on the tape,
    so gradients of gradients compose to any order."""
    from .ndarray import NDArray

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    heads, head_grads = _as_list(heads, head_grads)
    var_ids = {id(v) for v in variables}
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if h._data.grad_fn is None:
            if id(h) in var_ids:
                continue        # the variable itself: handled below
            raise MXNetError(
                "cannot differentiate a head that is not on the tape; "
                "call grad inside autograd.record()")
        outs.append(h._data)
        seeds.append(_seed(h, hg))
    targets = [v._leaf if v._leaf is not None else v._data
               for v in variables]
    diff = [i for i, t in enumerate(targets) if t.requires_grad]
    got = [None] * len(variables)
    if outs and diff:
        keep = create_graph if retain_graph is None else retain_graph
        with _RecordingScope(False, train_mode):
            res = torch.autograd.grad(
                outs, [targets[i] for i in diff], seeds,
                retain_graph=bool(keep), create_graph=create_graph,
                allow_unused=True)
        for i, g in zip(diff, res):
            got[i] = g
    results = []
    for v, g in zip(variables, got):
        for h, hg in zip(heads, head_grads):
            if h is v and h._data.grad_fn is None:
                s = _seed(h, hg)
                g = s if g is None else g + s
        if g is None:
            g = torch.zeros_like(v._data.detach())
        elif not create_graph:
            g = g.detach()
        if g.is_sparse:
            from .ndarray.sparse import RowSparseNDArray

            results.append(RowSparseNDArray(g._indices()[0], g._values(),
                                            g.shape, v._ctx))
            continue
        results.append(NDArray(g, v._ctx))
    return results[0] if single else results


def get_symbol(x):
    """The graph that produced ``x`` (reference: autograd.get_symbol):
    not kept by the tape, as in the JAX package; ``HybridBlock.export``
    writes a block's graph."""
    raise NotImplementedError(
        "symbol extraction from the imperative tape is not supported; "
        "use HybridBlock.export for a serialized graph")


class Function:
    """Custom differentiable function (reference: mx.autograd.Function).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays; call ``instance(*inputs)``.
    """

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *arrays):
        self._saved = arrays

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray

        with pause():
            outputs = self.forward(*inputs)
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        nd_inputs = [i for i in inputs if isinstance(i, NDArray)]
        if is_recording() and any(i._on_tape() for i in nd_inputs):
            func = self

            class _Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, *tensors):
                    return tuple(o._data.detach().clone() for o in outs)

                @staticmethod
                def backward(ctx, *cts):
                    with pause():
                        in_grads = func.backward(
                            *[NDArray(c, o._ctx) for c, o in zip(cts, outs)])
                    if not isinstance(in_grads, (list, tuple)):
                        in_grads = [in_grads]
                    return tuple(g._data if isinstance(g, NDArray) else g
                                 for g in in_grads)

            with torch.enable_grad():
                res = _Fn.apply(*[i._data for i in nd_inputs])
            for o, t in zip(outs, res):
                o._data = t
        return outs[0] if single else outs
