"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes`` (seconds to build, where a source that includes PyTorch's
headers takes minutes).  Builds happen at first use, from the sources in
the checkout only, into ``build/kernels/`` beside the package (listed in
``.gitignore``).  A library's file name carries a hash of its source, of
every header in ``csrc/`` and of the flags, so an edited source or header
is rebuilt and a stale library is never loaded.

The flat C API's library (``csrc/c_api.cc``, host code that embeds
CPython) is built here too, by ``build_c_api()`` with ``g++`` and
``python3-config`` as ``src/Makefile`` builds the JAX package's, into
``build/capi/``.

Nothing here runs at import: the CPU test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

#: kernel name -> source file, relative to the package
SOURCES = {
    "flash_attention_fwd": "csrc/flash_attention_fwd.cu",
    "flash_attention_bwd": "csrc/flash_attention_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: kernel name -> the ``ptxas`` lines (registers, shared memory, spills)
#: of its last build in this process
PTXAS_LOG: dict[str, list[str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels build on a host with the toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((PACKAGE_DIR / SOURCES[name]).read_bytes())
    for header in sorted((PACKAGE_DIR / "csrc").glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the seconds
    each build took; raises MXNetError with the compiler's output on a
    failure."""
    import time

    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(PACKAGE_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        PTXAS_LOG[n] = [ln for ln in log.splitlines()
                        if "ptxas" in ln or "spill" in ln]
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: a concurrent loader never
                                     # sees a half-written library
    if failed:
        raise MXNetError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def sass_counts(name: str, opcode: str = "HMMA") -> dict[str, int]:
    """Instructions of ``opcode`` in each kernel of the built library
    ``name``, by mangled kernel name, from ``cuobjdump --dump-sass`` (in
    the toolkit beside ``nvcc``)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-sass", str(_lib_path(name))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts: dict[str, int] = {}
    kernel = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            kernel = line.split(" : ", 1)[1]
            counts[kernel] = 0
        elif kernel is not None and f" {opcode}." in line:
            counts[kernel] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


# -- the flat C API (host code, no CUDA) ---------------------------------------

#: the C API's sources, relative to the package
C_API_SOURCES = ("csrc/c_api.cc", "csrc/mxtpu_c_api.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def _python_flags() -> tuple[list[str], list[str]]:
    """(include flags, link flags) for embedding this interpreter, from
    its ``python3-config`` (``--includes``; ``--ldflags --embed``, or
    ``--ldflags`` and ``-lpythonX.Y`` where ``--embed`` is missing), as
    ``src/Makefile`` takes them."""
    import sys

    ver = "%d.%d" % sys.version_info[:2]
    candidates = [Path(sys.executable).with_name(f"python{ver}-config"),
                  Path(sys.executable).with_name("python3-config")]
    tool = next((str(c) for c in candidates if c.exists()), None) or \
        shutil.which(f"python{ver}-config") or shutil.which("python3-config")
    if tool is None:
        raise MXNetError("python3-config not found: the C API embeds "
                         "CPython and needs its headers and link flags")
    inc = subprocess.run([tool, "--includes"], capture_output=True,
                         text=True, check=True).stdout.split()
    emb = subprocess.run([tool, "--ldflags", "--embed"], capture_output=True,
                         text=True)
    if emb.returncode == 0 and emb.stdout.strip():
        ld = emb.stdout.split()
    else:
        ld = subprocess.run([tool, "--ldflags"], capture_output=True,
                            text=True, check=True).stdout.split()
        ld.append(f"-lpython{ver}")
    return inc, ld


def _cxx() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++")


def c_api_path() -> Path:
    """Where the C API library of these sources and flags lives:
    ``build/capi/<hash>/libmxtpu.so`` (a directory of its own, so a
    program links it with ``-L<dir> -lmxtpu``).  The hash covers the
    sources, the flags, the compiler's path, the interpreter's version and
    its ``python3-config`` flags, so a library linked against another
    libpython is never found under this path."""
    import sys

    digest = hashlib.sha256()
    for src in C_API_SOURCES:
        digest.update(src.encode() + (PACKAGE_DIR / src).read_bytes())
    inc, ld = _python_flags()
    for part in (CXX_FLAGS, inc, ld, [str(_cxx()), sys.version]):
        digest.update(("\0".join(part) + "\n").encode())
    return BUILD_DIR.parent / "capi" / digest.hexdigest()[:12] / "libmxtpu.so"


def build_c_api() -> Path:
    """Compile ``csrc/c_api.cc`` into ``libmxtpu.so`` with ``g++`` unless
    it is built already; returns its path (its directory also serves
    ``-I`` for ``mxtpu_c_api.h`` beside the source).  Raises MXNetError
    with the compiler's output on a failure."""
    out = c_api_path()
    with _LOCK:
        if out.exists():
            return out
        cxx = _cxx()
        if cxx is None:
            raise MXNetError("g++ not found: the C API builds with a C++ "
                             "compiler")
        inc, ld = _python_flags()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, *inc, "-o", str(tmp),
               str(PACKAGE_DIR / C_API_SOURCES[0]), *ld]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise MXNetError("C API build failed:\n" + " ".join(cmd) + "\n"
                             + res.stdout + res.stderr)
        os.replace(tmp, out)
    return out
