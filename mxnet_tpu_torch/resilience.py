"""Fault tolerance: the retry primitive and the fault-injection harness
of the input path.

Counterpart of the parts of ``mxnet_tpu/resilience.py`` that the input
path calls (``resilience.py:122, 270-330, 412-430, 533-616``):

- :func:`retry_call` — exponential backoff with (decorrelated) jitter;
  :func:`io_retry` runs a record or file open under it with the
  ``MXTPU_IO_RETRIES`` (default 2) and ``MXTPU_IO_BACKOFF`` (default
  0.05 s) variables; a missing file is not retried.
- ``MXTPU_FAULT_INJECT`` — the same comma-separated ``site[:arg]`` grammar
  (``io_open:2,corrupt_record:5,worker_hang:3,data_skew:4``), with
  :func:`inject_failure`, :func:`fault_arg`, :func:`consume_fault` and
  :func:`reset_faults`; :func:`maybe_data_fault` is the loader's site
  (``worker_hang:K`` sleeps ``MXTPU_DATA_HANG_SECS``, ``data_skew:K``
  sleeps ``MXTPU_DATA_SKEW_SECS``).  The plan parses every site the JAX
  package knows, so a spec written for it is accepted here; the sites
  outside the input path have no hook yet.

The rest of the module (watchdogs, the resilient training loop, the
health plane and the gang's consensus) comes with the production planes,
ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import os
import random as _random
import sys
import threading
import time

from .base import MXNetError


class InjectedFault(MXNetError):
    """An error raised by the MXTPU_FAULT_INJECT test harness."""


# -- fault injection -----------------------------------------------------------

#: sites armed with a trigger count (``site:N`` fires N times)
_COUNTED = ("rendezvous", "io_open", "nan_grad", "inf_loss",
            "crash_during_save", "crash_before_manifest", "telemetry_crash",
            "telemetry_rotate", "corrupt_ckpt_write", "kill_coordinator",
            "corrupt_tune_db", "tune_oom")
#: sites armed once with an index argument (``site:K``)
_INDEXED = ("corrupt_record", "sigterm_at_step", "corrupt_shard",
            "worker_hang", "data_skew")
#: rank-targeted sites, repeatable
_RANKED = ("kill_rank", "slow_rank", "heartbeat_loss", "net_partition",
           "partition_split")
#: rank-targeted sites, one-shot per listed rank
_RANKED_ONCE = ("bit_flip_param", "bit_flip_grad", "bad_core", "pause_rank")


class _FaultPlan:
    """Parsed MXTPU_FAULT_INJECT with live counters."""

    def __init__(self, spec):
        self.spec = spec
        self.counts = {}     # site -> remaining trigger count
        self.args = {}       # site -> numeric arg
        self.list_args = {}  # site -> [rank, ...]
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            site, _, arg = item.partition(":")
            if site in _COUNTED:
                self.counts[site] = int(arg) if arg else 1
            elif site in _INDEXED:
                self.args[site] = int(arg) if arg else 0
                self.counts[site] = 1
            elif site in _RANKED:
                self.list_args.setdefault(site, []).append(
                    int(arg) if arg else 0)
            elif site in _RANKED_ONCE:
                r = int(arg) if arg else 0
                self.list_args.setdefault(site, []).append(r)
                self.counts[f"{site}:{r}"] = 1
            elif site in ("stall_collective", "stall"):
                self.args["stall_collective"] = float(arg) if arg else 3600.0
                self.counts["stall_collective"] = 1
            else:
                raise MXNetError(
                    f"MXTPU_FAULT_INJECT: unknown site {site!r} in "
                    f"{spec!r}")

    def consume(self, site):
        """True (and decrements) while the site still has failures left."""
        n = self.counts.get(site, 0)
        if n <= 0:
            return False
        self.counts[site] = n - 1
        return True

    def arg(self, site):
        return self.args.get(site)


_PLAN = None
_PLAN_SPEC = None
_PLAN_LOCK = threading.Lock()


def _plan():
    """The plan for the CURRENT env value; counters persist while the env
    is unchanged, and a change re-parses."""
    global _PLAN, _PLAN_SPEC
    spec = os.environ.get("MXTPU_FAULT_INJECT")
    with _PLAN_LOCK:
        if spec != _PLAN_SPEC:
            _PLAN = _FaultPlan(spec) if spec else None
            _PLAN_SPEC = spec
        return _PLAN


def reset_faults():
    """Drop cached injection counters."""
    global _PLAN, _PLAN_SPEC
    with _PLAN_LOCK:
        _PLAN = None
        _PLAN_SPEC = None


def inject_failure(site):
    """Raise InjectedFault if the site has injected failures remaining."""
    plan = _plan()
    if plan is not None and plan.consume(site):
        raise InjectedFault(f"injected {site} failure "
                            f"(MXTPU_FAULT_INJECT={plan.spec})")


def fault_arg(site):
    """The numeric argument of an armed site, or None (does not consume)."""
    plan = _plan()
    return None if plan is None else plan.arg(site)


def consume_fault(site):
    """True once per armed count for the site (non-raising variant)."""
    plan = _plan()
    return plan is not None and plan.consume(site)


def maybe_data_fault(batch_idx):
    """Input-pipeline fault sites, keyed by BATCH index, called from the
    loader worker fetching that batch (thread transport; spawn workers
    run the standard-library mirror in ``gluon/data/_shm_worker.py``):

    - ``worker_hang:K`` — the fetch of batch K sleeps
      ``MXTPU_DATA_HANG_SECS`` (default 10), one-shot: far past any sane
      ``MXTPU_DATA_TIMEOUT``, so the receive watchdog fires first.
    - ``data_skew:K`` — fetches of batches 0..K-1 each sleep
      ``MXTPU_DATA_SKEW_SECS`` (default 0.05); persistent.
    """
    k = fault_arg("worker_hang")
    if k is not None and int(k) == int(batch_idx) and \
            consume_fault("worker_hang"):
        time.sleep(float(os.environ.get("MXTPU_DATA_HANG_SECS", 10.0)))
        return
    k = fault_arg("data_skew")
    if k is not None and int(batch_idx) < int(k):
        time.sleep(float(os.environ.get("MXTPU_DATA_SKEW_SECS", 0.05)))


# -- retry primitive -----------------------------------------------------------

def retry_call(fn, *, retries=3, deadline=None, max_elapsed=None,
               backoff=0.1, max_backoff=5.0, jitter=True,
               retryable=(Exception,), non_retryable=(), on_retry=None,
               description=None):
    """Call ``fn()`` with exponential-backoff-with-jitter retries.

    - ``retries``: max retry count (total attempts = retries + 1)
    - ``max_elapsed``: hard cap on the total elapsed seconds: once a
      failed attempt finds the budget spent, MXNetError is raised
    - ``deadline``: total wall-clock budget; a retry whose backoff sleep
      would overshoot it raises instead
    - ``jitter``: True (default) draws each sleep from ``uniform(backoff,
      3 * previous_sleep)`` capped at ``max_backoff``; falsy gives the
      deterministic exponential; a float the proportional scheme
      ``exponential * (1 + jitter * U[0,1))``
    - ``retryable``/``non_retryable``: exception classes to retry / to
      re-raise at once (non_retryable wins)
    - ``on_retry(attempt, exc, sleep_s)``: observer hook
    """
    what = description or getattr(fn, "__name__", "call")
    start = time.monotonic()
    attempt = 0
    prev_sleep = backoff
    while True:
        try:
            return fn()
        except non_retryable:
            raise
        except retryable as e:
            if attempt >= retries:
                raise
            if max_elapsed is not None and \
                    time.monotonic() - start >= max_elapsed:
                raise MXNetError(
                    f"{what}: retry budget {max_elapsed}s exhausted after "
                    f"{attempt + 1} attempts: {e}") from e
            if jitter is True:
                sleep_s = min(max_backoff, _random.uniform(
                    backoff, max(prev_sleep * 3.0, backoff)))
                prev_sleep = sleep_s
            else:
                sleep_s = min(max_backoff, backoff * (2 ** attempt))
                if jitter:
                    sleep_s *= 1.0 + float(jitter) * _random.random()
            if deadline is not None and \
                    time.monotonic() - start + sleep_s > deadline:
                raise MXNetError(
                    f"{what}: retry deadline {deadline}s exceeded after "
                    f"{attempt + 1} attempts: {e}") from e
            if on_retry is not None:
                on_retry(attempt, e, sleep_s)
            else:
                sys.stderr.write(
                    f"[resilience] {what} failed (attempt {attempt + 1}/"
                    f"{retries + 1}): {e}; retrying in {sleep_s:.2f}s\n")
            time.sleep(sleep_s)
            attempt += 1


def io_retry(fn, description=None):
    """Retry a record or file open with the MXTPU_IO_* variables.  A
    missing file is not retried (a local ENOENT is deterministic); any
    other OSError, the flaky network-filesystem class, is."""
    retries = int(os.environ.get("MXTPU_IO_RETRIES", "2"))
    backoff = float(os.environ.get("MXTPU_IO_BACKOFF", "0.05"))

    def attempt():
        inject_failure("io_open")
        return fn()

    return retry_call(attempt, retries=retries, backoff=backoff,
                      retryable=(OSError, InjectedFault),
                      non_retryable=(FileNotFoundError,),
                      description=description or "io open")
