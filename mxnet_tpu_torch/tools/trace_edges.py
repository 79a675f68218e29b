"""Kernel records of a torch.profiler trace held whole by fences, and how
often a trace without them loses records at its start.

torch.profiler's CUDA trace can drop the first records it should hold: a
trace opened just before a CUDA graph's replay may miss the replay's
first kernels, and late in a long process a trace dropped every kernel
that ran in its first 65 ms or more, the same records trace after
trace.  ``kernel_records(fn)`` opens the trace, runs a fence of sleep
kernels, then ``fn``, then another fence, and returns the records
between the fences in start order.  Each trace waits on the host after
it opens and before it closes, ``PAD_S`` the first, so the fences start
well inside the window.  A trace that kept no fence record on one side
is taken again, up to ``TRACE_ATTEMPTS`` traces, each loss reported on
stderr and each new trace padded twice as long as the last; it raises
when every trace lost a side, so a count read from what it returns
covers ``fn`` whole.  ``TRACES`` keeps each fenced trace's pad and
lead: the first fence record's start in the window less the host's
time of its launch (with no pad, 12 ms early in ``chip_smoke.py`` on
the H100 and 60 ms at its end).

    python3 -m mxnet_tpu_torch.tools.trace_edges [--traces 20]
        [--batch 32] [--seq 512]

builds ``bench_bert``'s BERT-base step (bf16, flash) on the card, eager
Gluon and captured, opens ``traces`` one-step traces of each without the
fences and as many with them, and prints one JSON line: for each path
and each kind of trace, how many traces held fewer device records than
the most any trace of that kind held, and how many did not count each
flash kernel once per layer; then the card's name and power limit as
``nvidia-smi`` reads them.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

#: sleep kernels (~1 ms each at 1.98 GHz) on each side of the traced work;
#: late in a long process on the H100 a trace lost its first 22 records,
#: a 16-kernel fence and 6 of the work's, every time
FENCE_KERNELS, FENCE_CYCLES = 64, 2_000_000

#: traces a fenced count may take: late in the whole chip_smoke.py on the
#: H100 a trace lost its entire 64-kernel opening fence, with a ~100 ms
#: sleep kernel before it too; in another run five traces in a row lost
#: it, the same 1655 records each time
TRACE_ATTEMPTS = 5

#: seconds the first trace waits on the host after it opens and before
#: it closes; each later trace waits twice as long
PAD_S = 0.25

#: one dict a fenced trace: ``pad_s``, ``lead_ms`` (None when the first
#: record is no fence), ``held`` (both sides kept)
TRACES = []

#: the name of ``torch.cuda._sleep``'s kernel in a trace
FENCE_NAME = "spin_kernel"


def fence():
    """``FENCE_KERNELS`` sleep kernels on the current stream, then a
    synchronize."""
    for _ in range(FENCE_KERNELS):
        torch.cuda._sleep(FENCE_CYCLES)
    torch.cuda.synchronize()


def _device_records(prof):
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def _trace(fn, fenced, pad=0.0):
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opened = time.perf_counter()
        time.sleep(pad)
        launched = time.perf_counter() - opened
        if fenced:
            fence()
        fn()
        torch.cuda.synchronize()
        if fenced:
            fence()
        time.sleep(pad)
    events = _device_records(prof)
    if fenced:
        first = bool(events) and FENCE_NAME in events[0].name
        TRACES.append({
            "pad_s": pad,
            "held": first and FENCE_NAME in events[-1].name,
            "lead_ms": (events[0].time_range.start / 1e3 - launched * 1e3
                        if first else None)})
    return events


def _pad(attempt):
    return PAD_S * 2 ** attempt


def kernel_records(fn, attempts=TRACE_ATTEMPTS):
    """The device records (kernels, copies) of one call of ``fn`` from a
    torch.profiler trace whose first and last records are fence records,
    in start order, fences left out.  ``fn`` runs once a trace, again for
    each trace that lost a side (a caller whose ``fn`` may run only once
    passes ``attempts=1``), each new trace padded longer on the host.
    Raises ``AssertionError`` when all ``attempts`` traces lost one."""
    lost = []
    while len(lost) < attempts:
        pad = _pad(len(lost))
        events = _trace(fn, True, pad)
        is_fence = [FENCE_NAME in e.name for e in events]
        if events and is_fence[0] and is_fence[-1]:
            if lost:
                print(f"trace_edges: held with a pad of {pad} s after "
                      f"{len(lost)} lost", file=sys.stderr, flush=True)
            return [e for e, f in zip(events, is_fence) if not f]
        lost.append(
            f"{len(events)} device records, {sum(is_fence)} of "
            f"{2 * FENCE_KERNELS} fence records, first a fence "
            f"{bool(events) and is_fence[0]}, last a fence "
            f"{bool(events) and is_fence[-1]}, pad {pad} s")
        print(f"trace_edges: a trace lost a side of the traced work, "
              f"taken again: {lost[-1]}", file=sys.stderr, flush=True)
    raise AssertionError(f"torch.profiler's traces lost a side of the "
                         f"traced work {len(lost)} times: {lost}")


FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def _flash_counts(events):
    return [sum(f in e.name for e in events) for f in FLASH]


def run(traces=20, batch=32, seq=512):
    """Traces of one step of each path without and with the fences (see
    the module docstring); returns the result line as a dict."""
    from .bench_bert import card_line, step_fn

    layers = 12
    out = {"metric": "short_traces", "traces": traces, "batch": batch,
           "seq": seq}
    for path in ("captured", "gluon"):
        step = step_fn(path, batch, seq)
        for _ in range(3):
            float(step())
        sizes, flash = {"plain": [], "fenced": []}, {"plain": [],
                                                     "fenced": []}
        for _ in range(traces):
            plain = _trace(step, fenced=False)
            fenced = kernel_records(step)
            for kind, events in (("plain", plain), ("fenced", fenced)):
                sizes[kind].append(len(events))
                flash[kind].append(_flash_counts(events))
        for kind in ("plain", "fenced"):
            most = max(sizes[kind])
            out[f"{path}_{kind}"] = {
                "records": most,
                "short": sum(n < most for n in sizes[kind]),
                "records_lost": sorted(most - n for n in sizes[kind]
                                       if n < most),
                "flash_not_once_per_layer": sum(
                    c != [layers] * 3 for c in flash[kind])}
        del step
        torch.cuda.empty_cache()
    out["nvidia_smi"] = card_line()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_edges: traces the card; no CUDA device")
    print(json.dumps(run(a.traces, a.batch, a.seq)), flush=True)


if __name__ == "__main__":
    main()
