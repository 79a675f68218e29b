"""Kernel records of a torch.profiler trace held whole by fences, and how
often a trace without them loses records at its start.

torch.profiler's CUDA trace can drop records it should hold: a trace
opened just before a CUDA graph's replay may miss the replay's first
kernels, late in a long process a trace dropped every kernel that ran in
its first 65 ms or more, the same records trace after trace, and another
kept its fences but none of the work between them.  ``kernel_records(fn)``
opens the trace, runs a fence of sleep kernels and one short sleep (a
mark), then ``fn``, then a mark and another fence, and returns the
records between the fences in start order.  Each trace waits on the host after
it opens and before it closes, ``PAD_S`` the first, so the fences start
well inside the window.  A trace that kept no fence record on one side
or a mark is taken again, up to ``TRACE_ATTEMPTS`` traces, each loss
reported on stderr and each new trace padded twice as long as the last;
it raises when every trace lost one, so a count read from what it
returns covers ``fn`` whole.  ``TRACES`` keeps each fenced trace's pad, the
host's time in ``profile.__enter__`` and its lead: the first fence
record's start less the host's time of its launch, both counted from
the profiler's own start (kineto's trace start, which the records'
times count from), so a profiler that takes longer to start does not
show as lead.  ``reproduce(fn)`` takes many fenced traces back to back
with no pad and no retry, the check that a late trace keeps its
records.

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

#: one short sleep kernel on each side of the work, inside the fences (a
#: spin kernel shorter than ``MARK_MAX_US`` is a mark, a longer one a
#: fence): late in the whole chip_smoke.py on the H100 a trace kept both
#: fences and none of the work's records, so a trace holds the work whole
#: only when it holds both marks too.  Not told by place: many late
#: traces keep both ends but drop some fence records between them
MARK_CYCLES, MARK_MAX_US = 20_000, 200.0

#: one dict a fenced trace: ``pad_s``, ``enter_ms`` (the host's ms in
#: ``profile.__enter__``), ``base_ms`` (where in it the profiler's own
#: start lies), ``lead_ms`` (None when the first record is no fence),
#: ``marks`` and ``work`` (the marks and the other records it kept),
#: ``held`` (both fences and both marks kept)
TRACES = []

#: the name of ``torch.cuda._sleep``'s kernel in a trace
FENCE_NAME = "spin_kernel"


def fence():
    """``FENCE_KERNELS`` sleep kernels on the current stream, then a
    synchronize."""
    for _ in range(FENCE_KERNELS):
        torch.cuda._sleep(FENCE_CYCLES)
    torch.cuda.synchronize()


def _is_mark(e):
    return FENCE_NAME in e.name and \
        e.time_range.elapsed_us() < MARK_MAX_US


def _held(events):
    """Whether a fenced trace's records (in start order) begin and end
    with a fence record and hold both marks."""
    def fence_at(i):
        return FENCE_NAME in events[i].name and not _is_mark(events[i])

    return bool(events) and fence_at(0) and fence_at(-1) and \
        sum(_is_mark(e) for e in events) >= 2


def _device_records(prof):
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def _base_ns(prof, entered_ns):
    """The profiler's own start on the host's ``time.time_ns`` clock, the
    base its records' ``time_range`` counts from (kineto's trace start);
    ``entered_ns`` where the profiler does not expose it."""
    try:
        return int(prof.profiler.kineto_results.trace_start_ns())
    except (AttributeError, RuntimeError, TypeError):
        return entered_ns


def _trace(fn, fenced, pad=0.0):
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    before = time.time_ns()
    with prof:
        entered = time.time_ns()
        time.sleep(pad)
        launched = time.time_ns()
        if fenced:
            fence()
            torch.cuda._sleep(MARK_CYCLES)
        fn()
        torch.cuda.synchronize()
        if fenced:
            torch.cuda._sleep(MARK_CYCLES)
            fence()
        time.sleep(pad)
    events = _device_records(prof)
    if fenced:
        first = bool(events) and FENCE_NAME in events[0].name
        base = _base_ns(prof, entered)
        TRACES.append({
            "pad_s": pad,
            "enter_ms": (entered - before) / 1e6,
            "base_ms": (base - before) / 1e6,
            "marks": sum(_is_mark(e) for e in events),
            "work": sum(FENCE_NAME not in e.name for e in events),
            "held": _held(events),
            "lead_ms": (events[0].time_range.start / 1e3
                        - (launched - base) / 1e6 if first else None)})
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
        is_spin = [FENCE_NAME in e.name for e in events]
        if _held(events):
            if lost:
                print(f"trace_edges: held with a pad of {pad} s after "
                      f"{len(lost)} lost", file=sys.stderr, flush=True)
            return [e for e, f in zip(events, is_spin) if not f]
        lost.append(
            f"{len(events)} device records, {sum(is_spin)} of "
            f"{2 * FENCE_KERNELS + 2} fence and mark records "
            f"({sum(_is_mark(e) for e in events)} of 2 marks), first a "
            f"fence {bool(events) and is_spin[0]}, last a fence "
            f"{bool(events) and is_spin[-1]}, pad {pad} s")
        print(f"trace_edges: a trace lost a side of the traced work, "
              f"taken again: {lost[-1]}", file=sys.stderr, flush=True)
    raise AssertionError(f"torch.profiler's traces lost a side of the "
                         f"traced work {len(lost)} times: {lost}")


def reproduce(fn, traces=20):
    """``traces`` fenced traces of ``fn`` back to back with no pad and no
    retry; returns their ``TRACES`` entries (``enter_ms``, ``lead_ms``,
    ``held``) in order.  A trace that lost a side is logged, not
    retaken: this reads whether the traces lose records at all."""
    start = len(TRACES)
    for _ in range(traces):
        _trace(fn, True, 0.0)
    return TRACES[start:]


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
