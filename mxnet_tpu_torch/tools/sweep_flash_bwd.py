"""Sweep the tiles of the tensor-core flash kernels (the forward, dQ and
dK/dV) on the card.

Run from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 -m mxnet_tpu_torch.tools.sweep_flash_bwd [SOURCE ...]

SOURCE is ``flash_attention_fwd`` or ``flash_attention_bwd`` (default:
both).  Builds variants of ``csrc/flash_attention_fwd.cu`` (q rows per
block ``kFwdBlockM``, kv rows per ring stage ``kFwdBlockN``, ring depth
``kFwdStages``, the largest f32 head dim whose Q fragments stay in
registers ``kFwdQRegsF32``) and of ``csrc/flash_attention_bwd.cu`` (the
dQ kernel's q rows per block ``kDqBlockM``, kv rows per ring stage
``kDqBlockN`` and ring depth ``kDqStages``; the dK/dV kernel's q rows per
ring stage ``kDkvBlockQ`` and ring depth ``kDkvStages``), one nvcc per
variant, at most ``JOBS`` at a time, into ``build/sweep/``.  Each
variant's kernels (the forward; dQ and dK/dV side by side) are checked
against their plain versions at a ragged T=1000 and timed with CUDA
events at (8, 12, 1024, 64) f32 and bf16, causal.  Prints ptxas'
register and spill counts at D=64 and one line per variant, kernel and
dtype.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import subprocess
import sys
from pathlib import Path

import torch

from .. import _kernels
from ..ops import flash_attention as fa

SHAPE = (8, 12, 1024, 64)
JOBS = 16          # nvcc processes at a time
GRIDS = {
    "flash_attention_fwd": {"kFwdBlockM": (64, 128), "kFwdBlockN": (32, 64),
                            "kFwdStages": (2, 3), "kFwdQRegsF32": (0, 64)},
    "flash_attention_bwd": {"kDqBlockM": (64, 128), "kDqBlockN": (32, 64),
                            "kDqStages": (2, 3), "kDkvBlockQ": (32, 64),
                            "kDkvStages": (2, 3)},
}


def variants(lib):
    src = (_kernels.PACKAGE_DIR / _kernels.SOURCES[lib]).read_text()
    grid = GRIDS[lib]
    for values in itertools.product(*grid.values()):
        text = src
        for name, value in zip(grid, values):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in the source")
        yield dict(zip(grid, values)), text


def build_all(out_dir, libs=tuple(GRIDS)):
    """Every variant of the named sources, built together; returns
    [(lib, values, CDLL)]."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    csrc = _kernels.PACKAGE_DIR / "csrc"
    todo = []
    for lib in libs:
        for values, text in variants(lib):
            stem = out_dir / (lib + "_" + "_".join(map(str, values.values())))
            stem.with_suffix(".cu").write_text(text)
            todo.append((lib, values, stem))

    def start(stem):
        return subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    running = [(lib, v, stem, start(stem)) for lib, v, stem in todo[:JOBS]]
    todo = todo[JOBS:]
    libs = []
    while running:
        lib, values, stem, proc = running.pop(0)
        log, _ = proc.communicate()
        if todo:
            nxt = todo.pop(0)
            running.append((*nxt, start(nxt[2])))
        if proc.returncode:
            print(lib, values, "build failed:", log[-2000:])
            continue
        entries = re.findall(r"Compiling entry function '(\S+)'", log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        for e, r, sp in zip(entries, regs, spills):
            m = re.search(r"flash_(fwd|dq|dkv)_kernelI(f|13__nv_bfloat16)Li64E",
                          e)
            if m:
                print(f"{values} {m.group(1)} "
                      f"{'f32' if m.group(2) == 'f' else 'bf16'} D=64: {r} "
                      f"registers, {sp} bytes spilled")
        libs.append((lib, values, ctypes.CDLL(str(stem.with_suffix(".so")))))
    return libs


def _entry(lib, name, n_ptrs):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(lib, which, q, k, v, o, lse, do, delta):
    """A closure launching the variant's forward, dQ or dK/dV kernel
    (causal) into fresh outputs, and those outputs."""
    B, H, T, D = q.shape
    tail = (B * H, T, D, 0 if q.dtype == torch.float32 else 1, 1, D ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if which == "fwd":
        outs = (torch.empty_like(q),
                torch.empty((B * H, T), device=q.device))
        fn = _entry(lib, "flash_attention_fwd", 5)
        ptrs = [t.data_ptr() for t in (q, k, v, *outs)]
    elif which == "dq":
        outs = (torch.empty_like(q),
                torch.empty((B * H, T), device=q.device))
        fn = _entry(lib, "flash_attention_dq", 8)
        ptrs = [t.data_ptr() for t in (q, k, v, o, lse, do, *outs)]
    else:
        outs = (torch.empty_like(k), torch.empty_like(v))
        fn = _entry(lib, "flash_attention_dkv", 8)
        ptrs = [t.data_ptr() for t in (q, k, v, lse, do, delta, *outs)]

    def run():
        rc = fn(*ptrs, *tail)
        if rc:
            raise RuntimeError(f"launch refused, cudaError {rc}")

    return run, outs


def cuda_ms(fn, iters=20):
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


def main(argv=None):
    names = sys.argv[1:] if argv is None else argv
    unknown = set(names) - set(GRIDS)
    if unknown:
        raise SystemExit(f"unknown sources {sorted(unknown)}; "
                         f"choose from {list(GRIDS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    libs = build_all(Path("build") / "sweep", names or tuple(GRIDS))
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(SHAPE, device=dev, generator=g).to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        _, delta = fa.flash_attention_dq(q, k, v, o, lse, do, True)
        small = [x[:1, :2, :1000].contiguous() for x in (q, k, v, do)]
        so, slse = fa.flash_attention_plain(*small[:3], True)
        sdelta = (small[3].float() * so.float()).sum(-1).reshape(2, 1000)
        plain_bwd = fa.flash_attention_bwd_plain(*small[:3], so, slse,
                                                 small[3], True)
        want = {"fwd": (so, slse), "dq": (plain_bwd[0], sdelta),
                "dkv": plain_bwd[1:]}
        for lib, values, cdll in libs:
            for which in (("fwd",) if lib == "flash_attention_fwd"
                          else ("dq", "dkv")):
                try:
                    run, got = launcher(cdll, which, *small[:3], so, slse,
                                        small[3], sdelta)
                    run()
                    torch.cuda.synchronize()
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want[which]))
                    run, _ = launcher(cdll, which, q, k, v, o, lse, do,
                                      delta)
                    ms = cuda_ms(run)
                except RuntimeError as e:
                    print(f"{str(dtype)[6:]:8s} {which} {values}  {e}")
                    continue
                print(f"{str(dtype)[6:]:8s} {which:3s} {values}  {ms:.4f} "
                      f"ms  max abs err vs plain (T=1000) {err:.2e}",
                      flush=True)


if __name__ == "__main__":
    main()
