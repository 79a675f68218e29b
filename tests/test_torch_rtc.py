"""``mxnet_tpu_torch.rtc`` on the host: what can be checked without a
card or NVRTC.

The signature parser, the MXNetErrors ``get_kernel`` and ``launch`` raise
before any CUDA driver call (a bad signature, a missing export, a CPU
context, wrong arguments), and that ``CudaModule`` raises MXNetError, not
a fallback, where NVRTC or the card is missing.  A module is built here
from a stand-in CUBIN (``rtc._compile`` patched) so ``get_kernel`` can be
reached; compiling and launching are held on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.  The JAX
package's ``PallasModule`` test (``tests/test_aux.py:247``) is the
reference: its ``scale2`` kernel is the port's CUDA ``scale2``.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, rtc
from mxnet_tpu_torch.base import MXNetError
from torch_one_thread import one_torch_thread  # noqa: F401

AXPY = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha, int n)
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += alpha * x[i];
}
"""


def test_parse_signature():
    specs = rtc.parse_signature(
        "const float *x, float* y, float alpha, int n, const __half *h, "
        "int64_t *idx, uint8_t u, const double*, int8_t *q, int32_t m")
    got = [(s.name, s.ctype, s.is_pointer, s.is_const, s.dtype)
           for s in specs]
    assert got == [
        ("x", "float", True, True, torch.float32),
        ("y", "float", True, False, torch.float32),
        ("alpha", "float", False, False, torch.float32),
        ("n", "int", False, False, torch.int32),
        ("h", "__half", True, True, torch.float16),
        ("idx", "int64_t", True, False, torch.int64),
        ("u", "uint8_t", False, False, torch.uint8),
        ("arg7", "double", True, True, torch.float64),
        ("q", "int8_t", True, False, torch.int8),
        ("m", "int32_t", False, False, torch.int32)]
    assert rtc.parse_signature("") == []


@pytest.mark.parametrize("sig", ["float3 *x", "const float **x",
                                 "float *x, , int n", "unsigned long n",
                                 "std::vector<float> v"])
def test_bad_signature_raises(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


@pytest.fixture
def fake_module(monkeypatch):
    """A module over a stand-in CUBIN whose symbol table holds ``axpy``
    and the lowered name of ``scale<float>``."""
    lowered = {"scale<float>": "_Z5scaleIfEvPKT_PS0_i"}
    cubin = b"\x7fELF\0.text.axpy\0axpy\0_Z5scaleIfEvPKT_PS0_i\0"

    def compile_(source, options, exports):
        return cubin, {e: lowered[e] for e in exports}

    monkeypatch.setattr(rtc, "_compile", compile_)
    return rtc.CudaModule(AXPY, exports=["scale<float>"])


def test_get_kernel_resolves_exports_and_refuses_missing(fake_module):
    k = fake_module.get_kernel("axpy", "const float *x, float *y, "
                                       "float alpha, int n")
    assert k.symbol == "axpy" and k.launches == 0
    t = fake_module.get_kernel("scale<float>",
                               "const float *x, float *y, int n")
    assert t.symbol == "_Z5scaleIfEvPKT_PS0_i"
    for name in ("missing", "scale<double>", "xpy"):
        with pytest.raises(MXNetError, match="no kernel"):
            fake_module.get_kernel(name, "int n")
    with pytest.raises(MXNetError):
        fake_module.get_kernel("axpy", "float3 *x")


def test_launch_refuses_cpu_context_and_bad_arguments(fake_module):
    k = fake_module.get_kernel("axpy", "const float *x, float *y, "
                                       "float alpha, int n")
    with mx.cpu():
        x, y = nd.ones((8,)), nd.zeros((8,))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, y, 2.0, 8], mx.cpu(), (1, 1, 1), (8, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, y, 2.0, 8], torch.device("cpu"), (1,), (8,))
    # argument checks in the order launch makes them (the device of the
    # arrays named as the launch's, then a card's against host arrays)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    for args, dev, match in (
            ([x, y, 2.0], cpu, "arguments"),
            ([x, y.asnumpy(), 2.0, 8], cpu, "needs an NDArray"),
            ([x, y, x, 8], cpu, "scalar"),
            ([x, y.astype("float64"), 2.0, 8], cpu, "float32"),
            ([x, y.T, 2.0, 8], card, "is on cpu")):
        with pytest.raises(MXNetError, match=match):
            k._pack(args, dev)
    values, written = k._pack([x, y, 2.0, 8], cpu)
    assert written == [y] and [type(v).__name__ for v in values] == [
        "c_void_p", "c_void_p", "c_float", "c_int"]
    assert k.launches == 0
    np.testing.assert_array_equal(y.asnumpy(), 0.0)


def test_cuda_module_raises_without_nvrtc_or_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_kernels_gpu.py "
                    "compiles for real")
    with pytest.raises(MXNetError):
        mod = rtc.CudaModule(AXPY)
        k = mod.get_kernel("axpy", "const float *x, float *y, float alpha, "
                                   "int n")
        k.launch([], mx.gpu(0), (1,), (1,))


def test_pallas_module_points_to_cuda_module():
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasModule("def f(x): return x", exports=["f"])
    assert mx.rtc is rtc
