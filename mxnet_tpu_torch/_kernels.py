"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes`` (seconds to build, where a source that includes PyTorch's
headers takes minutes).  Builds happen at first use, from the sources in
the checkout only, into ``build/kernels/`` beside the package (listed in
``.gitignore``).  A library's file name carries a hash of its source, of
every header in ``csrc/`` and of the flags, so an edited source or header
is rebuilt and a stale library is never loaded.

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
