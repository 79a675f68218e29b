"""Sweep the flash-attention backward kernels' thread split on the card.

Run from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 -m mxnet_tpu_torch.tools.sweep_flash_bwd

Builds variants of ``csrc/flash_attention_bwd.cu`` that differ in three
constants (head dims a thread holds in the dQ kernel and in the dK/dV
kernel, and streamed rows per group), one nvcc per variant, all started
together, into ``build/sweep/``.  Each variant is checked against
``flash_attention_bwd_plain`` at a ragged T=1000 and timed with CUDA
events at (8, 12, 1024, 64) f32 and bf16, causal.  Prints ptxas' register
and spill counts at D=64 and one line per variant and dtype.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import subprocess
from pathlib import Path

import torch

from .. import _kernels
from ..ops import flash_attention as fa

SHAPE = (8, 12, 1024, 64)
GRID = {"kDqDims": (16, 32), "kDkvDims": (8, 16, 32), "kGroup": (2, 4, 8)}


def variants():
    src = (_kernels.PACKAGE_DIR / _kernels.SOURCES["flash_attention_bwd"]
           ).read_text()
    for values in itertools.product(*GRID.values()):
        text = src
        for name, value in zip(GRID, values):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in the source")
        yield values, text


def build_all(out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    procs = {}
    for values, text in variants():
        stem = out_dir / ("bwd_" + "_".join(map(str, values)))
        stem.with_suffix(".cu").write_text(text)
        procs[values] = (subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), stem)
    libs = {}
    for values, (proc, stem) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(values, "build failed:", log[-2000:])
            continue
        entries = re.findall(r"Compiling entry function '(\S+)'", log)
        stats = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        for e, r, sp in zip(entries, stats, spills):
            m = re.search(r"flash_(dq|dkv)_kernelI(f|13__nv_bfloat16)Li64E", e)
            if m and m.group(2) == "f":
                print(f"{values} {m.group(1)} f32 D=64: {r} registers, "
                      f"{sp} bytes spilled")
        libs[values] = ctypes.CDLL(str(stem.with_suffix(".so")))
    return libs


def _entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launchers(lib, q, k, v, o, lse, do):
    """Closures launching the variant's two kernels (causal) into fresh
    outputs, and those outputs."""
    B, H, T, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B * H, T), device=q.device)
    tail = (B * H, T, D, 0 if q.dtype == torch.float32 else 1, 1, D ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    f_dq, f_dkv = _entry(lib, "flash_attention_dq"), _entry(
        lib, "flash_attention_dkv")
    ptr = [t.data_ptr() for t in (q, k, v, o, lse, do, dq, delta, dk, dv)]

    def run_dq():
        assert f_dq(*ptr[:8], *tail) == 0

    def run_dkv():
        assert f_dkv(ptr[0], ptr[1], ptr[2], ptr[4], ptr[5], ptr[7], ptr[8],
                     ptr[9], *tail) == 0

    return run_dq, run_dkv, (dq, dk, dv)


def cuda_ms(fn, iters=10):
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    libs = build_all(Path("build") / "sweep")
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(SHAPE, device=dev, generator=g).to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        small = [x[:1, :2, :1000].contiguous() for x in (q, k, v, do)]
        so, slse = fa.flash_attention_fwd(*small[:3], True)
        want = fa.flash_attention_bwd_plain(*small[:3], so, slse, small[3],
                                            True)
        for values, lib in libs.items():
            run_dq, run_dkv, got = launchers(lib, *small[:3], so, slse,
                                             small[3])
            run_dq()
            run_dkv()
            torch.cuda.synchronize()
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            run_dq, run_dkv, _ = launchers(lib, q, k, v, o, lse, do)
            t_dq, t_dkv = cuda_ms(run_dq), cuda_ms(run_dkv)
            print(f"{str(dtype)[6:]:8s} kDqDims={values[0]:2d} "
                  f"kDkvDims={values[1]:2d} kGroup={values[2]}  dQ "
                  f"{t_dq:.4f} ms  dK/dV {t_dkv:.4f} ms  sum "
                  f"{t_dq + t_dkv:.4f} ms  max abs err (T=1000) {err:.2e}",
                  flush=True)


if __name__ == "__main__":
    main()
