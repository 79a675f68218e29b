"""The port's flat C API: ``libmxtpu.so`` built from
``mxnet_tpu_torch/csrc/c_api.cc`` by ``_kernels.build_c_api()``.

The ctypes round trips of ``tests/test_c_api.py`` (NDArray, an op, the op
list, autograd, the KVStore, error reporting) against the port's library,
attached to this process with the host as the C API's context; the C
predict API over a pair the JAX package exported, against the JAX
package's predictor on the same pair; and ``cpp-package``'s linear
regression example compiled from its unchanged sources, linked to the
port's library and run as a program of its own.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import c_api_impl as jimpl
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def capi():
    lib = ctypes.CDLL(str(_kernels.build_c_api()))
    lib.MXGetLastError.restype = ctypes.c_char_p
    assert lib.MXTPUInit() == 0, lib.MXGetLastError().decode()
    return lib


@pytest.fixture(autouse=True)
def on_host():
    """The C API's arrays on the host: this thread's ``with cpu():``."""
    with cpu():
        yield


def _err(lib):
    return lib.MXGetLastError().decode()


def _create(lib, arr):
    arr = np.ascontiguousarray(arr)
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    h = ctypes.c_void_p()
    rc = lib.MXNDArrayCreate(
        arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes, shape, arr.ndim,
        arr.dtype.name.encode(), ctypes.byref(h))
    assert rc == 0, _err(lib)
    return h


def _read(lib, h, shape, dtype=np.float32):
    out = np.empty(shape, dtype)
    rc = lib.MXNDArraySyncCopyToCPU(
        h, out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    assert rc == 0, _err(lib)
    return out


def _invoke(lib, name, handles, params=None, n_out=4):
    params = params or {}
    keys = (ctypes.c_char_p * len(params))(*[k.encode() for k in params])
    vals = (ctypes.c_char_p * len(params))(
        *[str(v).encode() for v in params.values()])
    ins = (ctypes.c_void_p * len(handles))(*[h.value for h in handles])
    outs = (ctypes.c_void_p * n_out)()
    n = ctypes.c_int(n_out)
    rc = lib.MXImperativeInvoke(name.encode(), ins, len(handles), keys,
                                vals, len(params), outs, ctypes.byref(n))
    assert rc == 0, _err(lib)
    return [ctypes.c_void_p(outs[i]) for i in range(n.value)]


def test_ndarray_roundtrip(capi):
    lib = capi
    for x in (np.arange(6, dtype=np.float32).reshape(2, 3),
              np.arange(-4, 4, dtype=np.int8).reshape(2, 4)):
        h = _create(lib, x)
        ndim = ctypes.c_int()
        shape = (ctypes.c_int64 * 8)()
        assert lib.MXNDArrayGetShape(h, ctypes.byref(ndim), shape) == 0
        assert (ndim.value, shape[0], shape[1]) == (2,) + x.shape
        dt = ctypes.create_string_buffer(16)
        assert lib.MXNDArrayGetDType(h, dt) == 0
        assert dt.value == x.dtype.name.encode()
        nbytes = ctypes.c_size_t()
        assert lib.MXNDArraySize(h, ctypes.byref(nbytes)) == 0
        assert nbytes.value == x.nbytes
        np.testing.assert_array_equal(_read(lib, h, x.shape, x.dtype), x)
        assert lib.MXNDArrayFree(h) == 0


def test_invoke_op_and_list(capi):
    lib = capi
    x = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    h = _create(lib, x)
    (out,) = _invoke(lib, "sin", [h])
    np.testing.assert_allclose(_read(lib, out, (2, 3)), np.sin(x), rtol=1e-6)
    (t,) = _invoke(lib, "transpose", [h], {"axes": "(1, 0)"})
    np.testing.assert_array_equal(_read(lib, t, (3, 2)), x.T)
    q = _invoke(lib, "_contrib_quantize_v2", [h])
    assert len(q) == 3
    np.testing.assert_array_equal(
        _read(lib, q[0], (2, 3), np.int8), np.round(x * 127).astype(np.int8))
    for hh in [h, out, t] + q:
        lib.MXNDArrayFree(hh)
    count = ctypes.c_int()
    names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXListAllOpNames(ctypes.byref(count), ctypes.byref(names)) == 0
    got = {names[i].decode() for i in range(count.value)}
    assert {"sin", "FullyConnected", "Convolution",
            "_contrib_quantized_conv"} <= got
    assert count.value > 300


def test_autograd(capi):
    lib = capi
    x = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    h = _create(lib, x)
    assert lib.MXAutogradAttachGrad(h) == 0, _err(lib)
    assert lib.MXAutogradRecordStart() == 0
    (sq,) = _invoke(lib, "square", [h])
    (loss,) = _invoke(lib, "sum", [sq])
    assert lib.MXAutogradRecordStop() == 0
    assert lib.MXAutogradBackward(loss) == 0, _err(lib)
    g = ctypes.c_void_p()
    assert lib.MXNDArrayGetGrad(h, ctypes.byref(g)) == 0, _err(lib)
    np.testing.assert_allclose(_read(lib, g, (3,)), 2 * x, rtol=1e-6)
    for hh in (h, sq, loss, g):
        lib.MXNDArrayFree(hh)


def test_kvstore(capi):
    lib = capi
    kv = ctypes.c_int()
    assert lib.MXKVStoreCreate(b"local", ctypes.byref(kv)) == 0, _err(lib)
    v = np.ones(4, dtype=np.float32)
    h = _create(lib, v)
    assert lib.MXKVStoreInit(kv, 3, h) == 0, _err(lib)
    h2 = _create(lib, 2 * v)
    assert lib.MXKVStorePush(kv, 3, h2) == 0, _err(lib)
    out = ctypes.c_void_p()
    assert lib.MXKVStorePull(kv, 3, ctypes.byref(out)) == 0, _err(lib)
    np.testing.assert_allclose(_read(lib, out, (4,)), 2 * v)
    assert lib.MXKVStorePull(kv, 9, ctypes.byref(out)) == -1
    assert "not initialized" in _err(lib)
    assert lib.MXKVStoreFree(kv) == 0
    for hh in (h, h2, out):
        lib.MXNDArrayFree(hh)


def test_error_reporting(capi):
    lib = capi
    x = _create(lib, np.ones(2, np.float32))
    outs = (ctypes.c_void_p * 1)()
    n = ctypes.c_int(1)
    rc = lib.MXImperativeInvoke(b"definitely_not_an_op",
                                (ctypes.c_void_p * 1)(x.value), 1,
                                None, None, 0, outs, ctypes.byref(n))
    assert rc == -1
    assert "definitely_not_an_op" in _err(lib)
    h = ctypes.c_void_p()
    rc = lib.MXPredCreate(b"{}", None, 0, 7, 0, 0, None, ctypes.byref(h))
    assert rc == -1 and "dev_type" in _err(lib)
    lib.MXNDArrayFree(x)


def test_predict_api_against_the_jax_predictor(capi, tmp_path):
    """MXPred* over a pair the JAX package exported: the port's output
    equals the JAX package's predictor's (``c_api_impl.pred_*``) on the
    same symbol, parameters and input."""
    lib = capi
    rs = np.random.RandomState(0)
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(8, activation="relu"), jgluon.nn.Dense(3))
    net.initialize(init=mx.init.Xavier())
    net.hybridize()
    x = rs.randn(2, 5).astype(np.float32)
    net(jnd.array(x))
    net.export(str(tmp_path / "pred"))
    sym_json = (tmp_path / "pred-symbol.json").read_text()
    param_bytes = (tmp_path / "pred-0000.params").read_bytes()
    pid = jimpl.pred_create(sym_json, param_bytes, ["data"])
    jimpl.pred_set_input(pid, "data", x.tobytes(), x.shape)
    jimpl.pred_forward(pid)
    want = np.frombuffer(jimpl.pred_get_output(pid, 0), np.float32).reshape(
        jimpl.pred_output_shape(pid, 0))
    jimpl.pred_free(pid)

    h = ctypes.c_void_p()
    keys = (ctypes.c_char_p * 1)(b"data")
    rc = lib.MXPredCreate(sym_json.encode(), param_bytes, len(param_bytes),
                          1, 0, 1, keys, ctypes.byref(h))
    assert rc == 0, _err(lib)
    shape = (ctypes.c_int64 * 2)(2, 5)
    rc = lib.MXPredSetInput(h, b"data", x.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), shape, 2)
    assert rc == 0, _err(lib)
    assert lib.MXPredForward(h) == 0, _err(lib)
    ndim = ctypes.c_int()
    oshape = (ctypes.c_int64 * 8)()
    assert lib.MXPredGetOutputShape(h, 0, ctypes.byref(ndim), oshape) == 0
    shp = tuple(oshape[i] for i in range(ndim.value))
    assert shp == want.shape == (2, 3)
    out = np.empty(shp, np.float32)
    assert lib.MXPredGetOutput(h, 0, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), out.size) == 0, _err(lib)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    assert lib.MXPredFree(h) == 0, _err(lib)


def test_cpp_package_linreg_example(tmp_path):
    """cpp-package's linear regression, from its unchanged sources, linked
    to the port's library: a C++ program with no Python of its own that
    boots the port with MXTPUInit() and trains through the C ABI alone."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    lib = _kernels.build_c_api()
    binp = str(tmp_path / "linreg")
    r = subprocess.run(
        ["g++", "-std=c++17",
         os.path.join(ROOT, "cpp-package", "example", "linreg.cpp"),
         "-I" + os.path.join(ROOT, "cpp-package", "include", "mxnet-tpu-cpp"),
         "-I" + CSRC, "-L" + str(lib.parent), "-lmxtpu",
         "-Wl,-rpath," + str(lib.parent), "-o", binp],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-500:]
    env = dict(os.environ, MXTPU_C_API_CONTEXT="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([binp], capture_output=True, text=True, env=env,
                         timeout=240)
    assert run.returncode == 0, (run.stdout[-300:], run.stderr[-300:])
    assert "PASS" in run.stdout
