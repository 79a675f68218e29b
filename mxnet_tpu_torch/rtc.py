"""Runtime kernel compilation: ``CudaModule`` compiles user CUDA C++ for
``sm_90a`` and launches it on NDArrays.

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasModule`` (the JAX
package's runtime compiler, ``exec`` of user source wrapping
``pl.pallas_call``) is its TPU kernel site; this is the facility for the
card, with MXNet's own ``mx.rtc.CudaModule`` semantics (reference:
python/mxnet/rtc.py over src/common/rtc.cc):

- **Compile** with NVRTC (``libnvrtc.so`` through ``ctypes``):
  ``--gpu-architecture=sm_90a`` plus the caller's ``options``, to a CUBIN
  (``nvrtcGetCUBIN``).  Each entry of ``exports`` is a name expression
  (``nvrtcAddNameExpression``/``nvrtcGetLoweredName``), so templated and
  non-``extern "C"`` kernels resolve.  A compile error raises MXNetError
  carrying the program log.  CUBINs are cached in memory by a hash of the
  source, options and exports.
- **Load and launch** through the driver API (``libcuda.so``):
  ``cuModuleLoadData``, ``cuModuleGetFunction``, ``cuLaunchKernel`` in the
  device's primary context (the one torch uses, retained rather than
  created), on ``torch.cuda.current_stream(dev)``, so a kernel orders with
  torch's own work without a sync.
- **Signature**: MXNet's string, e.g. ``"const float *x, float *y, float
  alpha, int n"``; pointers and scalars of ``float``, ``double``,
  ``__half``, ``uint8_t``, ``int8_t``, ``int32_t``/``int`` and
  ``int64_t`` (a kernel source declares these types itself, or includes
  ``<cuda_fp16.h>`` and ``<cstdint>``: the toolkit's headers are on the
  include path).  ``launch`` raises MXNetError on a wrong argument count, an
  array whose dtype differs from its pointer type, a pointer argument that
  is not an NDArray, an array on another device or not contiguous, and a
  CPU context.
- **Writes stay where they belong.** A non-const pointer's array is
  written in place and no other NDArray sees it (no two NDArrays share a
  buffer, ``ndarray/ndarray.py``); its ``_version`` is bumped, and so is
  torch's version counter, so a retained autograd graph that saved the old
  value refuses to run rather than read the new one.  ``launch`` returns
  None; a memory fault in the kernel surfaces as an error at the next
  sync, where CUDA reports it.

There is no fallback: without NVRTC, without a card, or on a compile
error, ``CudaModule`` raises MXNetError.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import threading
import time

import numpy as _np
import torch

from .base import MXNetError

ARCH = "sm_90a"

# C type -> (torch dtype, ctypes type of a scalar argument)
_C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),    # passed as its bits
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_ARG_RE = re.compile(r"^(const\s+)?([A-Za-z_][A-Za-z_0-9 ]*?)\s*(\*)?\s*"
                     r"([A-Za-z_][A-Za-z_0-9]*)?$")


class ArgSpec:
    """One parameter of a kernel signature."""

    __slots__ = ("name", "ctype", "dtype", "scalar_type", "is_pointer",
                 "is_const")

    def __init__(self, name, ctype, is_pointer, is_const):
        self.name, self.ctype = name, ctype
        self.is_pointer, self.is_const = is_pointer, is_const
        self.dtype, self.scalar_type = _C_TYPES[ctype]

    def __repr__(self):
        return (f"{'const ' if self.is_const else ''}{self.ctype}"
                f"{' *' if self.is_pointer else ' '}{self.name}")


def parse_signature(signature: str) -> list:
    """Parse MXNet's kernel signature string into ArgSpecs; raise
    MXNetError on a type it does not take or a malformed argument."""
    specs = []
    for i, part in enumerate(p.strip() for p in signature.split(",")):
        if not part and signature.strip() == "":
            break
        m = _ARG_RE.match(part)
        if m is None:
            raise MXNetError(f"rtc: cannot parse argument {i} {part!r} of "
                             f"signature {signature!r}")
        const, ctype, star, name = m.groups()
        ctype = " ".join(ctype.split())
        if ctype not in _C_TYPES:
            raise MXNetError(
                f"rtc: argument {i} {part!r} has type {ctype!r}; supported "
                f"types are {sorted(_C_TYPES)}")
        specs.append(ArgSpec(name or f"arg{i}", ctype, bool(star),
                             bool(const)))
    return specs


# -- the two libraries, loaded at first use ------------------------------------

_LOCK = threading.Lock()
_LIBS: dict = {}

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIZE = ctypes.POINTER(ctypes.c_size_t)
_NVRTC_SIGS = {
    "nvrtcCreateProgram": [_PP, _S, _S, _I, _P, _P],
    "nvrtcAddNameExpression": [_P, _S],
    "nvrtcCompileProgram": [_P, _I, ctypes.POINTER(_S)],
    "nvrtcGetProgramLogSize": [_P, _SIZE],
    "nvrtcGetProgramLog": [_P, _S],
    "nvrtcGetLoweredName": [_P, _S, ctypes.POINTER(_S)],
    "nvrtcGetCUBINSize": [_P, _SIZE],
    "nvrtcGetCUBIN": [_P, _S],
    "nvrtcDestroyProgram": [_PP],
    "nvrtcGetErrorString": [_I],
}
_CU_SIGS = {
    "cuInit": [ctypes.c_uint],
    "cuGetErrorString": [_I, ctypes.POINTER(_S)],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [_PP, _I],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, _S],
    "cuModuleGetFunction": [_PP, _P, _S],
    "cuFuncSetAttribute": [_P, _I, _I],
    "cuLaunchKernel": [_P] + [ctypes.c_uint] * 7 + [_P, _PP, _PP],
}


def _declare(lib, sigs):
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    return lib


def _cuda_home():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvrtc_candidates():
    """libnvrtc from the loader's path, the toolkit, or the NVIDIA wheel
    beside torch."""
    site = os.path.dirname(os.path.dirname(torch.__file__))
    found = []
    for pat in (os.path.join(_cuda_home(), "lib64", "libnvrtc.so*"),
                os.path.join(site, "nvidia", "cuda_nvrtc", "lib",
                             "libnvrtc.so*")):
        found += sorted(glob.glob(pat))
    return ["libnvrtc.so"] + found


def _nvrtc():
    with _LOCK:
        if "nvrtc" not in _LIBS:
            lib, tried = None, []
            for cand in _nvrtc_candidates():
                try:
                    lib = ctypes.CDLL(cand)
                    break
                except OSError:
                    tried.append(cand)
            if lib is None:
                raise MXNetError(
                    "rtc.CudaModule: NVRTC (libnvrtc.so) not found (set "
                    "CUDA_HOME to the CUDA toolkit); tried " + ", ".join(tried))
            _declare(lib, _NVRTC_SIGS).nvrtcGetErrorString.restype = _S
            _LIBS["nvrtc"] = lib
        return _LIBS["nvrtc"]


def _cuda():
    with _LOCK:
        if "cuda" not in _LIBS:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise MXNetError(f"rtc: the CUDA driver (libcuda.so.1) is "
                                 f"not available: {e}") from None
            _check_cu(_declare(lib, _CU_SIGS), lib.cuInit(0), "cuInit")
            _LIBS["cuda"] = lib
        return _LIBS["cuda"]


def _check_nvrtc(lib, rc, what):
    if rc != 0:
        raise MXNetError(f"rtc: {what} failed: "
                         f"{lib.nvrtcGetErrorString(rc).decode()}")


def _check_cu(lib, rc, what):
    if rc != 0:
        s = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(s))
        raise MXNetError(f"rtc: {what} failed: CUresult {rc} "
                         f"({(s.value or b'?').decode()})")


def _program_log(lib, prog):
    size = ctypes.c_size_t()
    if lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)) != 0:
        return ""
    buf = ctypes.create_string_buffer(size.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace")


def _compile(source: str, options: tuple, exports: tuple):
    """NVRTC: source -> (CUBIN bytes, {name expression: lowered name})."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None,
        None), "nvrtcCreateProgram")
    try:
        for e in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, e.encode()),
                         f"nvrtcAddNameExpression({e!r})")
        opts = [f"--gpu-architecture={ARCH}"]
        include = os.path.join(_cuda_home(), "include")   # cuda_fp16.h
        if os.path.isdir(include):
            opts.append(f"--include-path={include}")
        opts += list(options)
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        rc = lib.nvrtcCompileProgram(prog, len(opts), arr)
        if rc != 0:
            raise MXNetError(
                f"rtc.CudaModule: compilation failed "
                f"({lib.nvrtcGetErrorString(rc).decode()}); options "
                f"{opts}; log:\n{_program_log(lib, prog)}")
        lowered = {}
        for e in exports:
            name = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, e.encode(), ctypes.byref(name)),
                f"nvrtcGetLoweredName({e!r})")
            lowered[e] = name.value.decode()
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        return buf.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


_CUBINS: dict = {}


class CudaModule:
    """Compile CUDA C++ ``source`` at runtime for ``sm_90a``.

    ``options``: extra NVRTC options; ``exports``: name expressions of
    kernels to resolve (templates, C++ names).  Example::

        mod = mx.rtc.CudaModule(source, exports=["scale<float>"])
        k = mod.get_kernel("scale<float>", "const float *x, float *y, int n")
        k.launch([x, y, x.size], mx.gpu(0), (blocks, 1, 1), (256, 1, 1))
    """

    def __init__(self, source, options=(), exports=()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        key = hashlib.sha256(repr((source, self.options, self.exports))
                             .encode()).hexdigest()
        t0 = time.perf_counter()
        if key not in _CUBINS:
            _CUBINS[key] = _compile(source, self.options, self.exports)
        self.cubin, self.lowered = _CUBINS[key]
        #: seconds this constructor spent compiling (0 on a cache hit)
        self.compile_seconds = time.perf_counter() - t0
        self._modules: dict = {}     # device ordinal -> CUmodule

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an export's name expression, or an
        ``extern "C"`` function name) with MXNet's ``signature``."""
        symbol = self.lowered.get(name, name)
        if b"\0" + symbol.encode() + b"\0" not in self.cubin:
            raise MXNetError(
                f"rtc: no kernel {name!r} in the module (exports: "
                f"{list(self.exports)}); a C++ or templated kernel must be "
                f"declared in exports=[...]")
        return CudaKernel(self, name, symbol, parse_signature(signature))

    def _function(self, ordinal, symbol):
        lib = _cuda()
        mod = self._modules.get(ordinal)
        if mod is None:
            mod = ctypes.c_void_p()
            _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod),
                                                self.cubin),
                      "cuModuleLoadData")
            self._modules[ordinal] = mod
        fn = ctypes.c_void_p()
        _check_cu(lib, lib.cuModuleGetFunction(ctypes.byref(fn), mod,
                                               symbol.encode()),
                  f"cuModuleGetFunction({symbol!r})")
        return fn


_PRIMARY: dict = {}


def _make_current(ordinal):
    """Make the device's primary context (torch's) current on this
    thread."""
    lib = _cuda()
    ctx = _PRIMARY.get(ordinal)
    if ctx is None:
        dev = ctypes.c_int()
        _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _PRIMARY[ordinal] = ctx
    _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


_MAX_DYNAMIC_SHARED = 8   # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES


class CudaKernel:
    """One kernel of a CudaModule (reference: mx.rtc.CudaKernel).
    ``launches`` counts the launches this object made."""

    def __init__(self, module, name, symbol, specs):
        self.module, self.name, self.symbol = module, name, symbol
        self.specs = specs
        self.launches = 0
        self._fns: dict = {}

    def _pack(self, args, device):
        """ctypes values for ``args``, checked against the signature;
        also the tensors written through non-const pointers."""
        from .ndarray import NDArray

        if len(args) != len(self.specs):
            raise MXNetError(f"rtc {self.name}: {len(args)} arguments for "
                             f"signature {self.specs}")
        values, written = [], []
        for i, (a, s) in enumerate(zip(args, self.specs)):
            if s.is_pointer:
                if not isinstance(a, NDArray):
                    raise MXNetError(f"rtc {self.name}: argument {i} ({s}) "
                                     f"needs an NDArray, got {type(a)}")
                t = a._data
                if t.dtype != s.dtype:
                    raise MXNetError(f"rtc {self.name}: argument {i} ({s}) "
                                     f"needs {s.dtype}, got {t.dtype}")
                if t.device != device:
                    raise MXNetError(f"rtc {self.name}: argument {i} ({s}) "
                                     f"is on {t.device}, the launch on "
                                     f"{device}")
                if not t.is_contiguous():
                    raise MXNetError(f"rtc {self.name}: argument {i} ({s}) "
                                     "is not contiguous")
                values.append(ctypes.c_void_p(t.data_ptr()))
                if not s.is_const:
                    written.append(a)
            else:
                if isinstance(a, (NDArray, torch.Tensor)):
                    raise MXNetError(f"rtc {self.name}: argument {i} ({s}) "
                                     f"is a scalar, got an array")
                if s.dtype == torch.float16:
                    a = int(_np.float16(a).view(_np.uint16))
                elif not s.dtype.is_floating_point:
                    a = int(a)
                values.append(s.scalar_type(a))
        return values, written

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU Context) over ``grid_dims`` blocks of
        ``block_dims`` threads with ``shared_mem`` bytes of dynamic shared
        memory, on the device's current stream; returns None."""
        from .context import Context

        device = ctx.device if isinstance(ctx, Context) \
            else torch.device(ctx)
        if device.type != "cuda":
            raise MXNetError(f"rtc {self.name}: launch needs a GPU context, "
                             f"got {ctx}")
        ordinal = 0 if device.index is None else device.index
        values, written = self._pack(args, torch.device("cuda", ordinal))
        grid = tuple(grid_dims) + (1,) * (3 - len(grid_dims))
        block = tuple(block_dims) + (1,) * (3 - len(block_dims))
        stream = torch.cuda.current_stream(ordinal).cuda_stream
        lib = _cuda()
        _make_current(ordinal)
        fn = self._fns.get(ordinal)
        if fn is None:
            fn = self._fns[ordinal] = self.module._function(ordinal,
                                                            self.symbol)
        if shared_mem > 48 * 1024:
            _check_cu(lib, lib.cuFuncSetAttribute(
                fn, _MAX_DYNAMIC_SHARED, int(shared_mem)),
                "cuFuncSetAttribute")
        params = (ctypes.c_void_p * max(1, len(values)))(
            *[ctypes.addressof(v) for v in values])
        _check_cu(lib, lib.cuLaunchKernel(
            fn, *grid, *block, int(shared_mem), stream, params, None),
            f"cuLaunchKernel({self.name})")
        self.launches += 1
        for a in written:
            a._version += 1
            torch.autograd.graph.increment_version(a._data)


class PallasModule:
    """The JAX package's runtime Pallas compiler has no counterpart on the
    card: Pallas targets the TPU.  Raises with guidance, the mirror of the
    JAX package's ``CudaModule`` shim."""

    def __init__(self, source, options=(), exports=()):
        raise MXNetError(
            "mx.rtc.PallasModule compiles Pallas kernels, which target the "
            "TPU.  On this port write the kernel in CUDA C++ and use "
            "mx.rtc.CudaModule(source, exports=[...]); get_kernel(name, "
            "signature).launch(args, mx.gpu(0), grid_dims, block_dims).")
