"""Testing utilities.

Counterpart of ``mxnet_tpu/test_utils.py`` (reference:
python/mxnet/test_utils.py, the testing backbone): assert_almost_equal,
check_numeric_gradient, check_symbolic_forward/backward,
check_consistency, rand_ndarray, default_context, simple_forward.

``list_gpus`` lists the visible CUDA cards, and ``check_consistency`` is
the reference's CPU<->GPU oracle over the port's two backends: the same
function on host tensors and on the card's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .context import Context, current_context
from .ndarray.ndarray import NDArray


def default_context():
    """The test context: ``MXNET_TEST_DEFAULT_CONTEXT`` (``cpu``,
    ``gpu(1)`` ...) when set, else ``current_context()`` (reference:
    default_context)."""
    name = os.environ.get("MXNET_TEST_DEFAULT_CONTEXT", "")
    if name:
        dev, _, idx = name.partition("(")
        idx = int(idx.rstrip(")")) if idx else 0
        return Context(dev.strip(), idx)
    return current_context()


def default_dtype():
    return np.float32


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same(a, b):
    return np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    a, b = _as_np(a), _as_np(b)
    return np.allclose(a, b,
                       rtol=1e-5 if rtol is None else rtol,
                       atol=1e-20 if atol is None else atol,
                       equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Comparison with dtype-aware default tolerances (reference:
    assert_almost_equal)."""
    a_np, b_np = _as_np(a), _as_np(b)
    if rtol is None or atol is None:
        dt = np.result_type(a_np.dtype, b_np.dtype)
        defaults = {np.dtype(np.float16): (1e-2, 1e-3),
                    np.dtype(np.float32): (1e-4, 1e-5),
                    np.dtype(np.float64): (1e-6, 1e-7)}
        d_rtol, d_atol = defaults.get(np.dtype(dt), (1e-4, 1e-5))
        rtol = rtol if rtol is not None else d_rtol
        atol = atol if atol is not None else d_atol
    np.testing.assert_allclose(a_np, b_np, rtol=rtol, atol=atol,
                               equal_nan=equal_nan,
                               err_msg=f"{names[0]} vs {names[1]}")


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=np.float32,
                 scale=1.0, ctx=None):
    """Uniform values in [-scale, scale) from numpy's global generator, as
    an NDArray on ``ctx`` (default ``current_context()``)."""
    from . import ndarray as nd

    arr = nd.array(np.random.uniform(-scale, scale, shape).astype(dtype),
                   ctx=ctx, dtype=dtype)
    return arr.tostype(stype) if stype != "default" else arr


def random_arrays(*shapes):
    arrays = [np.random.randn(*s).astype(np.float32) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def list_gpus():
    """The visible CUDA cards' indices (reference: mx.test_utils.list_gpus)."""
    return list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []


def simple_forward(fn, *inputs, **kwargs):
    from . import ndarray as nd

    arrays = [nd.array(np.asarray(i)) if not isinstance(i, NDArray) else i
              for i in inputs]
    out = fn(*arrays, **kwargs)
    if isinstance(out, (list, tuple)):
        return [o.asnumpy() for o in out]
    return out.asnumpy()


def check_numeric_gradient(fn, inputs, eps=1e-4, rtol=1e-2, atol=1e-4,
                           argnums=None):
    """Finite-difference check of the autograd gradients of ``sum(fn)``
    (reference: check_numeric_gradient).  ``fn`` maps NDArrays to an
    NDArray (or a list of them); ``inputs`` are numpy arrays, placed on
    ``current_context()``."""
    from . import autograd
    from . import ndarray as nd

    inputs = [np.asarray(x, dtype=np.float64).astype(np.float32)
              for x in inputs]
    if argnums is None:
        argnums = range(len(inputs))

    arrs = [nd.array(x) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs)
        loss = out.sum() if hasattr(out, "sum") else sum(
            o.sum() for o in out)
    loss.backward()
    analytic = [a.grad.asnumpy() for a in arrs]

    for i in argnums:
        x = inputs[i]
        numeric = np.zeros_like(x)
        flat = x.reshape(-1)
        num_flat = numeric.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            plus = _loss_of(fn, inputs, nd)
            flat[j] = orig - eps
            minus = _loss_of(fn, inputs, nd)
            flat[j] = orig
            num_flat[j] = (plus - minus) / (2 * eps)
        np.testing.assert_allclose(
            analytic[i], numeric, rtol=rtol, atol=atol,
            err_msg=f"gradient mismatch for input {i}")


def _loss_of(fn, inputs, nd):
    out = fn(*[nd.array(x) for x in inputs])
    if isinstance(out, (list, tuple)):
        return float(sum(float(o.sum().asscalar()) for o in out))
    return float(out.sum().asscalar())


def check_symbolic_forward(fn, inputs, expected, rtol=1e-4, atol=1e-5):
    """Run ``fn`` on ``inputs`` (numpy), compare with the expected numpy
    outputs."""
    from . import ndarray as nd

    out = fn(*[nd.array(np.asarray(x)) for x in inputs])
    outs = out if isinstance(out, (list, tuple)) else [out]
    expected = expected if isinstance(expected, (list, tuple)) \
        else [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol=rtol, atol=atol)


def check_symbolic_backward(fn, inputs, out_grads, expected_grads,
                            rtol=1e-4, atol=1e-5):
    from . import autograd
    from . import ndarray as nd

    arrs = [nd.array(np.asarray(x)) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs)
    out.backward(nd.array(np.asarray(out_grads[0]))
                 if out_grads else None)
    for a, e in zip(arrs, expected_grads):
        if e is None:
            continue
        assert_almost_equal(a.grad, e, rtol=rtol, atol=atol)


def check_consistency(fn, inputs, backends=("cpu",), rtol=1e-4,
                      atol=1e-5):
    """Cross-backend consistency oracle (reference: the CPU<->GPU sweep of
    tests/python/gpu/test_operator_gpu.py): ``fn`` on tensors of
    ``inputs`` (numpy) on each backend, ``cpu`` and ``gpu``, a backend
    with no device left out; each output (a tensor, an NDArray or a tuple
    of them) against the previous backend's.  Returns [(backend, [numpy
    outputs])] for the backends that ran."""
    results = []
    for backend in backends:
        if backend == "gpu" and not torch.cuda.is_available():
            continue
        dev = torch.device("cuda", 0) if backend == "gpu" else \
            torch.device("cpu")
        args = [torch.as_tensor(np.asarray(x), device=dev) for x in inputs]
        out = fn(*args)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        results.append((backend, [_as_np(o) for o in outs]))
    for (b1, r1), (b2, r2) in zip(results, results[1:]):
        assert len(r1) == len(r2), (b1, b2)
        for i, (x1, x2) in enumerate(zip(r1, r2)):
            np.testing.assert_allclose(
                x1, x2, rtol=rtol, atol=atol,
                err_msg=f"output {i} inconsistent between {b1} and {b2}")
    return results


def discover_type(dtype):
    return np.dtype(dtype)
