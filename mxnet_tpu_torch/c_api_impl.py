"""Python side of the flat C API.

Counterpart of ``mxnet_tpu/c_api_impl.py`` (reference: src/c_api/c_api.cc
+ c_api_ndarray.cc + c_predict_api.cc).  The port's C library
(``csrc/c_api.cc``, built by ``_kernels.build_c_api()`` into
``libmxtpu.so``) embeds CPython, or attaches to the process that loaded
it, and calls the helpers below.  Each takes and returns simple types
(bytes, str, int, tuples, NDArray handles), so the C side marshals no
tensors; handles cross the ABI as opaque PyObject*.

Arrays live on the C API's context: the innermost ``with ctx:`` scope of
the calling thread when one is open (a Python process driving the library
through ctypes), else ``MXTPU_C_API_CONTEXT`` (``cpu``, ``gpu``,
``gpu(1)``), else ``gpu(0)``: an embedded runtime runs on the card unless
it is told otherwise.  A predictor runs where ``MXPredCreate``'s
``dev_type`` (1 the host, 2 a card) and ``dev_id`` put it.
"""

from __future__ import annotations

import ast
import os

import numpy as np

_RECORD_SCOPES = []
_KVSTORES = {}
_NEXT_KV = [1]


def _context():
    from .context import Context, scoped_context

    scoped = scoped_context()
    if scoped is not None:
        return scoped
    name = os.environ.get("MXTPU_C_API_CONTEXT", "gpu").strip()
    dev, _, idx = name.partition("(")
    return Context(dev.strip(), int(idx.rstrip(")")) if idx else 0)


def create(buf, shape, dtype):
    """bytes + shape + dtype name -> NDArray handle."""
    from . import ndarray as nd

    arr = np.frombuffer(bytes(buf), dtype=np.dtype(dtype))
    arr = arr.reshape(tuple(shape)).copy()
    return nd.array(arr, ctx=_context(), dtype=np.dtype(dtype))


def to_bytes(h):
    return h.asnumpy().tobytes()


def shape_of(h):
    return tuple(int(s) for s in h.shape)


def dtype_of(h):
    return np.dtype(h.dtype).name


def size_bytes(h):
    return int(h.size) * np.dtype(h.dtype).itemsize


def invoke(name, inputs, keys, vals):
    """MXImperativeInvoke: an op by registered name, its params strings
    (literal-evaluated, as the reference's string-typed param dict).
    Unknown names raise through the registry.  Returns a list of output
    handles."""
    from .ndarray.register import invoke_registered

    kwargs = {}
    for k, v in zip(keys, vals):
        try:
            kwargs[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            kwargs[k] = v
    with _context():
        out = invoke_registered(name, tuple(inputs), kwargs)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def list_op_names():
    from .ops.registry import list_ops

    return list_ops()


# -- autograd ------------------------------------------------------------------

def attach_grad(h):
    h.attach_grad()


def record_start():
    from . import autograd

    scope = autograd.record()
    scope.__enter__()
    _RECORD_SCOPES.append(scope)


def record_stop():
    if _RECORD_SCOPES:
        _RECORD_SCOPES.pop().__exit__(None, None, None)


def backward(h):
    h.backward()


def grad_of(h):
    g = h.grad
    if g is None:
        raise ValueError("no gradient attached")
    return g


# -- kvstore -------------------------------------------------------------------

def kv_create(kind):
    from . import kvstore

    kv = kvstore.create(kind)
    kid = _NEXT_KV[0]
    _NEXT_KV[0] += 1
    _KVSTORES[kid] = kv
    return kid


def kv_init(kid, key, h):
    _KVSTORES[kid].init(int(key), h)


def kv_push(kid, key, h):
    _KVSTORES[kid].push(int(key), h)


def kv_pull(kid, key):
    from . import ndarray as nd
    from .base import MXNetError

    kv = _KVSTORES[kid]
    if int(key) not in kv._store:
        raise MXNetError(f"key {int(key)} not initialized")
    stored = kv._store[int(key)]
    out = nd.zeros(stored.shape, ctx=stored.context, dtype=stored.dtype)
    kv.pull(int(key), out=out)
    return out


def kv_free(kid):
    _KVSTORES.pop(kid, None)


# -- predictor (reference: c_predict_api.h / c_predict_api.cc) -----------------

_PREDICTORS = {}
_NEXT_PRED = [1]


def pred_create(symbol_json, param_bytes, input_names, dev_type=2,
                dev_id=0):
    """symbol.json text + .params file bytes + input names -> handle: a
    SymbolBlock built as ``gluon.SymbolBlock.imports`` builds one, from
    in-memory buffers (the reference's amalgamation/predict use), its
    parameters in their saved dtypes on the host (``dev_type`` 1) or card
    ``dev_id`` (2)."""
    import tempfile

    from . import symbol as sym_mod
    from .base import MXNetError
    from .context import cpu, gpu
    from .gluon.block import SymbolBlock

    if int(dev_type) not in (1, 2):
        raise MXNetError(f"MXPredCreate: dev_type {dev_type} (1 cpu, 2 gpu)")
    ctx = cpu() if int(dev_type) == 1 else gpu(int(dev_id))
    sym = sym_mod.fromjson(symbol_json)
    names = [str(n) for n in input_names]
    block = SymbolBlock(sym, [sym_mod.var(n) for n in names])
    if param_bytes:
        fd, path = tempfile.mkstemp(suffix=".params")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(bytes(param_bytes))
            block.collect_params().load(path, ctx=ctx, cast_dtype=True,
                                        dtype_source="saved",
                                        allow_missing=False,
                                        ignore_extra=True)
        finally:
            os.remove(path)
    pid = _NEXT_PRED[0]
    _NEXT_PRED[0] += 1
    _PREDICTORS[pid] = {"block": block, "inputs": {}, "names": names,
                        "outputs": None, "ctx": ctx}
    return pid


def pred_set_input(pid, key, buf, shape):
    from . import ndarray as nd

    p = _PREDICTORS[pid]
    arr = np.frombuffer(bytes(buf), dtype=np.float32).reshape(
        tuple(shape)).copy()
    p["inputs"][str(key)] = nd.array(arr, ctx=p["ctx"])


def pred_forward(pid):
    import torch

    from . import autograd

    p = _PREDICTORS[pid]
    args = [p["inputs"][n] for n in p["names"]]
    with autograd.predict_mode(), torch.no_grad():
        out = p["block"](*args)
    p["outputs"] = list(out) if isinstance(out, (list, tuple)) else [out]


def pred_output_shape(pid, index):
    p = _PREDICTORS[pid]
    return tuple(int(d) for d in p["outputs"][int(index)].shape)


def pred_get_output(pid, index):
    p = _PREDICTORS[pid]
    return p["outputs"][int(index)].astype("float32").asnumpy().tobytes()


def pred_free(pid):
    _PREDICTORS.pop(int(pid), None)
