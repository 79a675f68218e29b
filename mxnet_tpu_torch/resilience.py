"""Fault tolerance: retries, watchdogs, the fault-injection harness and
the resilient training loop.

Counterpart of the one-process half of ``mxnet_tpu/resilience.py``
(lines 122-1306) with the heartbeat plane its serving replicas run on
(``HeartbeatPublisher``, ``FailureDetector`` and the failure exceptions).
The failure modes: preemption (SIGTERM with a grace window), corrupt or
truncated records and checkpoints, a flaky filesystem, and blocking work
that never returns.

- :func:`retry_call`: exponential backoff with jitter, behind the
  rendezvous (``distributed.py``) and every record or file open.
- :class:`Watchdog`: a thread armed around blocking host work; on expiry
  it dumps every Python thread's stack, then interrupts the main thread
  or exits.  It never touches CUDA: an expiry during a device sync acts
  once the sync returns.
- :func:`run_resilient`: a supervised training loop composing
  ``checkpoint.PreemptionHandler``, resume from the newest valid
  checkpoint and bounded in-process restarts, with verify-after-write
  and a fallback to the previous checkpoint when the newest is corrupt.
  Its ``gang=`` (elastic recovery across processes) comes with the gang
  slice and raises ``NotImplementedError``.
- ``MXTPU_FAULT_INJECT``: every site of the JAX package's plan, with the
  same grammar, so each recovery path is testable on the CPU.

Environment variables:

==============================  ================================================
``MXTPU_RENDEZVOUS_TIMEOUT``    total seconds to keep retrying rendezvous (300)
``MXTPU_RENDEZVOUS_RETRIES``    max rendezvous attempts - 1 (3)
``MXTPU_IO_RETRIES``            retries for record/file opens (2)
``MXTPU_IO_BACKOFF``            base backoff seconds for IO retries (0.05)
``MXTPU_COLLECTIVE_TIMEOUT``    watchdog seconds around eager collectives
                                (unset = no watchdog)
``MXTPU_STEP_TIMEOUT``          watchdog seconds around a captured step
                                (unset = no watchdog)
``MXTPU_WATCHDOG_ACTION``       ``interrupt`` (default) or ``abort`` — abort is
                                the only escape from a wedged C call
``MXTPU_WATCHDOG_EXIT_CODE``    process exit code for ``abort`` (124)
``MXTPU_FAULT_INJECT``          comma list of ``site[:arg]`` fault specs
==============================  ================================================

Fault-injection sites (``MXTPU_FAULT_INJECT="site:arg,site:arg"``):

- ``rendezvous:N``      — fail the next N rendezvous attempts
- ``io_open:N``         — fail the next N record/file opens
- ``corrupt_record:K``  — the K-th record a reader returns reads as corrupt
- ``sigterm_at_step:S`` — deliver SIGTERM to this process at step S
                          (honored by :func:`run_resilient`)
- ``stall_collective[:SECS]`` — stall inside the next guarded collective
                          (default 3600s — the watchdog must fire first)
- ``crash_during_save``  — hard-kill the process mid-shard-write (the
                          async checkpoint engine, checkpoint.py)
- ``crash_before_manifest`` — hard-kill after all shards are written but
                          before the manifest commit rename
- ``corrupt_shard:K``    — flip bytes in shard K of the checkpoint that
                          was just committed
- ``corrupt_ckpt_write:N`` — bit-rot the next N committed
                          LocalCheckpointer files (verify-after-write
                          must catch them)
- ``kill_rank:K``        — SIGKILL this process when it IS gang rank K
                          (optionally gated on ``MXTPU_KILL_AT_STEP``);
                          repeatable: ``kill_rank:1,kill_rank:2``
- ``slow_rank:K``        — rank K sleeps ``MXTPU_SLOW_RANK_SECS`` per
                          step tick (straggler injection)
- ``heartbeat_loss:K``   — rank K stops publishing heartbeats while the
                          process keeps running (the wedged-alive mode)
- ``corrupt_tune_db:N``  — bit-rot the next N tuning-DB entries as they
                          are written (autotune/db.py; readers must fall
                          back to defaults, never crash)
- ``tune_oom:N``         — the next N autotune trials fail with a
                          simulated RESOURCE_EXHAUSTED (the infeasible-
                          point path, hermetic on CPU)
- ``bit_flip_param:K``   — flip one bit in rank K's first parameter
                          after a step commits (memory SDC; one-shot —
                          integrity.py attestation must name rank K)
- ``bit_flip_grad:K``    — flip one bit in rank K's first gradient
                          before the update (eager path, nan_grad
                          routing discipline)
- ``bad_core:K``         — rank K's step input is perturbed so its
                          compute is deterministically wrong (compute
                          SDC; replay audit classifies it)
- ``worker_hang:K``      — the DataLoader worker fetching batch K hangs
                          (``MXTPU_DATA_HANG_SECS``, far past any
                          receive timeout) — the ``MXTPU_DATA_TIMEOUT``
                          watchdog must name the batch, not block
- ``data_skew:K``        — fetches of the first K batches each sleep
                          ``MXTPU_DATA_SKEW_SECS`` (input-skew
                          straggler injection)

The gang's health plane (``StragglerMonitor``, ``ElasticGang``,
``ScalePolicy``) comes with the gang slice.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import pickle
import random as _random
import signal
import struct
import sys
import threading
import time
import traceback
import zlib

from .base import MXNetError


class InjectedFault(MXNetError):
    """An error raised by the MXTPU_FAULT_INJECT test harness."""


class WatchdogExpired(MXNetError):
    """Blocking work outlived its Watchdog deadline."""


class CheckpointCorrupt(MXNetError):
    """A checkpoint failed validation (bad magic/length/checksum)."""


def _tel_event(kind, /, **fields):
    """Structured telemetry event (imported late: telemetry imports
    this module when it writes)."""
    try:
        from . import telemetry
    except ImportError:
        return
    telemetry.event(kind, **fields)


# -- fault injection -----------------------------------------------------------

class _FaultPlan:
    """Parsed MXTPU_FAULT_INJECT with live counters."""

    def __init__(self, spec):
        self.spec = spec
        self.counts = {}   # site -> remaining trigger count
        self.args = {}     # site -> numeric arg (step index, seconds, ...)
        self.list_args = {}  # site -> [rank, ...] (repeatable rank sites)
        self.partition_started = None  # monotonic t of first blocked op
        self.partition_healed = False  # heal announced (telemetry, once)
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            site, _, arg = item.partition(":")
            if site in ("rendezvous", "io_open", "nan_grad", "inf_loss",
                        "crash_during_save", "crash_before_manifest",
                        "telemetry_crash", "telemetry_rotate",
                        "corrupt_ckpt_write",
                        "kill_coordinator", "corrupt_tune_db",
                        "tune_oom"):
                # telemetry_rotate: crash between the telemetry sink's
                # rename-to-.1 and the reopen (telemetry._rotate_locked)
                # — the torn-rotation window readers must survive
                # corrupt_tune_db: bit-rot the next N tuning-DB entry
                # lines as they are written (autotune/db.record) — the
                # CRC check must read them as absent, never crash;
                # tune_oom: the next N autotune trials raise a
                # RESOURCE_EXHAUSTED (autotune/runner.run_trial) and
                # must score infeasible
                # kill_coordinator: the gang KV daemon
                # (distributed.GangKVServer) drops dead on the Nth
                # mutation — mid-protocol, no reply, connections cut —
                # exercising the TcpKV client failover path
                # nan_grad: poison one gradient with NaN before health
                # assessment (consumed by the Trainer's numerics guard);
                # inf_loss: corrupt the loss seen by
                # numerics.DivergenceMonitor.observe;
                # telemetry_crash: kill the process mid-JSONL-append
                # (telemetry._emit) to prove the log stays parseable;
                # corrupt_ckpt_write: bit-rot the next N committed
                # LocalCheckpointer files (verify-after-write coverage)
                self.counts[site] = int(arg) if arg else 1
            elif site in ("corrupt_record", "sigterm_at_step",
                          "corrupt_shard", "worker_hang", "data_skew"):
                # worker_hang: the loader worker fetching batch K
                # sleeps MXTPU_DATA_HANG_SECS (one-shot) — exercises
                # the MXTPU_DATA_TIMEOUT receive watchdog;
                # data_skew: fetches of the first K batches each sleep
                # MXTPU_DATA_SKEW_SECS (persistent input straggler)
                self.args[site] = int(arg) if arg else 0
                self.counts[site] = 1
            elif site in ("kill_rank", "slow_rank", "heartbeat_loss",
                          "net_partition", "partition_split"):
                # rank-targeted sites: repeatable ("kill_rank:1,
                # kill_rank:2"), persistent conditions (no counter) —
                # each process checks its OWN gang rank against the
                # list.  net_partition:K cuts rank K's TcpKV client off
                # from the coordinator (every op raises GangKVError)
                # while the process keeps running.
                # partition_split:K is the ASYMMETRIC variant: listed
                # ranks (the minority group) get net_partition-style
                # timeouts on every gang-KV op while unlisted ranks
                # keep full connectivity; the cut HEALS after
                # MXTPU_PARTITION_SECS (measured from the first blocked
                # op), after which the fenced minority can rejoin
                self.list_args.setdefault(site, []).append(
                    int(arg) if arg else 0)
            elif site in ("bit_flip_param", "bit_flip_grad",
                          "bad_core", "pause_rank"):
                # silent-data-corruption sites (integrity.py): rank-
                # targeted like kill_rank, but ONE-SHOT per listed rank
                # — bit_flip_param:K flips one bit in rank K's first
                # parameter after a step commits (memory SDC);
                # bit_flip_grad:K flips one bit in a gradient before
                # the update (eager path only, nan_grad routing);
                # bad_core:K perturbs rank K's step input so its
                # compute is deterministically wrong (compute SDC);
                # pause_rank:K SIGSTOPs rank K's process for
                # MXTPU_PAUSE_SECS then SIGCONTs it (one-shot) — the
                # zombie-rank scenario: suspended across a reshape,
                # resumed after its own eviction
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
    is unchanged, and a change (tests flipping the fixture) re-parses."""
    global _PLAN, _PLAN_SPEC
    spec = os.environ.get("MXTPU_FAULT_INJECT")
    with _PLAN_LOCK:
        if spec != _PLAN_SPEC:
            _PLAN = _FaultPlan(spec) if spec else None
            _PLAN_SPEC = spec
        return _PLAN


def reset_faults():
    """Drop cached injection counters (the `faults` conftest fixture)."""
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


def fault_args(site):
    """All arguments of a repeatable rank-targeted site (kill_rank /
    slow_rank / heartbeat_loss), as a tuple; empty when unarmed."""
    plan = _plan()
    return () if plan is None else tuple(plan.list_args.get(site, ()))


def consume_fault(site):
    """True once per armed count for the site (non-raising variant)."""
    plan = _plan()
    return plan is not None and plan.consume(site)


def fault_armed(site):
    """True while the site still has injected failures pending (does NOT
    consume).  Lets a fast path that cannot express a site's fault —
    e.g. the captured train step, whose gradients never materialize for
    ``nan_grad`` poisoning — route the affected step to the path that
    can.  Rank-targeted sites keep their one-shot charges under
    ``site:rank`` keys — armed while ANY listed rank's charge is
    unspent."""
    plan = _plan()
    if plan is None:
        return False
    if plan.counts.get(site, 0) > 0:
        return True
    prefix = site + ":"
    return any(v > 0 for k, v in plan.counts.items()
               if k.startswith(prefix))


def consume_rank_fault(site, rank):
    """One-shot rank-targeted charge: True exactly once for each rank
    listed on the site (``bit_flip_param:1`` fires once on rank 1,
    never again, never on anyone else).  The per-rank charge lives in
    the same counter table as counted sites, keyed ``site:rank``."""
    if rank not in fault_args(site):
        return False
    plan = _plan()
    return plan is not None and plan.consume(f"{site}:{int(rank)}")


def consume_charges(site, on_last=True):
    """Shared charge-consumption semantics for counted sites.

    Consumes ONE charge of ``site`` (when any remain) and reports
    whether the fault should FIRE now:

    - ``on_last=True`` (kill_coordinator semantics): the fault fires on the LAST charge only — ``site:N`` means
      "survive N-1 occurrences, die on the Nth".  Returns True when
      the charge just consumed was the final one.
    - ``on_last=False`` (corrupt_ckpt_write / corrupt_shard
      semantics): every charge fires — ``site:N`` corrupts the next N
      occurrences.  Returns True for each consumed charge.
    """
    plan = _plan()
    if plan is None or not plan.consume(site):
        return False
    if not on_last:
        return True
    return plan.counts.get(site, 0) <= 0


#: exit code of an injected hard crash (``crash_during_save`` /
#: ``crash_before_manifest``) — distinct from the watchdog's 124 so the
#: crash-consistency tests can assert WHICH kill fired.
CRASH_EXIT_CODE = 57


def maybe_crash(site):
    """Injected hard crash: ``os._exit`` with no cleanup, no atexit, no
    flush — the closest a test can get to power loss / OOM-kill."""
    plan = _plan()
    if plan is not None and plan.consume(site):
        sys.stderr.write(f"[resilience] injected crash at {site}\n")
        sys.stderr.flush()
        os._exit(CRASH_EXIT_CODE)


def maybe_stall(site="stall_collective"):
    """Injected stall: sleep in small interruptible increments so an
    'interrupt' watchdog can break the stall (a real wedged C collective
    needs action='abort'; see Watchdog)."""
    plan = _plan()
    if plan is None or not plan.consume("stall_collective"):
        return
    seconds = plan.arg("stall_collective") or 3600.0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        time.sleep(0.05)


def maybe_data_fault(batch_idx):
    """Input-pipeline fault sites, keyed by BATCH index, called from the
    loader worker fetching that batch (thread transport; spawn workers
    run the stdlib mirror in ``gluon/data/_shm_worker.py``):

    - ``worker_hang:K`` — the fetch of batch K sleeps
      ``MXTPU_DATA_HANG_SECS`` (default 10, bounded so interpreter
      teardown can't deadlock on the worker), one-shot.  Far past any
      sane ``MXTPU_DATA_TIMEOUT``, so the receive watchdog fires first.
    - ``data_skew:K`` — fetches of batches 0..K-1 each sleep
      ``MXTPU_DATA_SKEW_SECS`` (default 0.05); persistent, never
      consumed (straggler-style input skew).
    """
    k = fault_arg("worker_hang")
    if k is not None and int(k) == int(batch_idx) and \
            consume_fault("worker_hang"):
        time.sleep(float(os.environ.get("MXTPU_DATA_HANG_SECS", 10.0)))
        return
    k = fault_arg("data_skew")
    if k is not None and int(batch_idx) < int(k):
        time.sleep(float(os.environ.get("MXTPU_DATA_SKEW_SECS", 0.05)))


def maybe_kill_rank(rank, step=None):
    """``kill_rank:K``: SIGKILL this process when its gang rank is K —
    no cleanup, no atexit, no SIGTERM grace.  ``MXTPU_KILL_AT_STEP``
    (when set AND a step is supplied) gates the kill to one exact step,
    so the multi-process tests control precisely which snapshots exist
    when the rank dies."""
    if rank not in fault_args("kill_rank"):
        return
    at = os.environ.get("MXTPU_KILL_AT_STEP")
    if at is not None and step is not None and int(at) != int(step):
        return
    sys.stderr.write(f"[resilience] injected kill_rank: SIGKILL rank "
                     f"{rank} at step {step}\n")
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_slow_rank(rank):
    """``slow_rank:K``: rank K sleeps MXTPU_SLOW_RANK_SECS (0.2) per
    step tick — a persistent straggler the StragglerMonitor must name."""
    if rank in fault_args("slow_rank"):
        time.sleep(float(os.environ.get("MXTPU_SLOW_RANK_SECS", "0.2")))


def partition_blocked(rank):
    """``partition_split:K``: True while rank K's side of the injected
    asymmetric partition is cut off from the gang KV.  The cut heals
    ``MXTPU_PARTITION_SECS`` (default 0 = never) after the FIRST blocked
    op, so one plan expresses the whole partition lifecycle: minority
    fences, majority reshapes, minority rejoins after the heal.  Checked
    by the KV transports (``FileKV`` / ``TcpKV``), which raise
    ``GangKVError`` while blocked."""
    plan = _plan()
    if plan is None or rank not in plan.list_args.get(
            "partition_split", ()):
        return False
    now = time.monotonic()
    with _PLAN_LOCK:
        if plan.partition_started is None:
            plan.partition_started = now
        started = plan.partition_started
    try:
        heal_s = float(os.environ.get("MXTPU_PARTITION_SECS", "0"))
    except ValueError:
        heal_s = 0.0
    if heal_s > 0 and now - started >= heal_s:
        return False
    return True


def maybe_pause_rank(rank):
    """``pause_rank:K``: SIGSTOP this process when its gang rank is K
    (one-shot), with a detached helper process sending SIGCONT after
    ``MXTPU_PAUSE_SECS`` (default 3).  The zombie scenario: by resume
    time the gang has reshaped this rank out, and its very next KV
    touch must learn the committed epoch and raise ``GangEvicted``
    before any durable write."""
    if not consume_rank_fault("pause_rank", rank):
        return
    secs = float(os.environ.get("MXTPU_PAUSE_SECS", "3.0"))
    sys.stderr.write(f"[resilience] injected pause_rank: SIGSTOP rank "
                     f"{rank} for {secs}s\n")
    sys.stderr.flush()
    import subprocess

    subprocess.Popen(
        [sys.executable, "-c",
         f"import os, signal, time; time.sleep({secs}); "
         f"os.kill({os.getpid()}, signal.SIGCONT)"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    os.kill(os.getpid(), signal.SIGSTOP)


# -- durable IO ----------------------------------------------------------------

def fsync_dir(path):
    """fsync a DIRECTORY so a just-renamed entry survives power loss.

    ``os.replace`` makes a write atomic but not durable: the rename
    itself lives in the directory inode, which ``fsync`` of the data
    file never touches.  Both checkpointers call this after every
    rename-commit.  Filesystems that refuse directory fds (some network
    mounts) are tolerated — they journal renames themselves.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- retry primitive -----------------------------------------------------------

def retry_call(fn, *, retries=3, deadline=None, max_elapsed=None,
               backoff=0.1, max_backoff=5.0, jitter=True,
               retryable=(Exception,), non_retryable=(), on_retry=None,
               description=None):
    """Call ``fn()`` with exponential-backoff-with-jitter retries.

    - ``retries``: max retry count (total attempts = retries + 1)
    - ``max_elapsed``: hard cap on TOTAL elapsed seconds (off by
      default): once a failed attempt finds the budget spent the
      original exception is re-raised — unlike ``deadline`` it cannot
      be overshot by a slow ``fn()`` (e.g. a full connect-timeout per
      attempt during a network partition), which is what lets
      partition-era KV retries fail over to fencing checks instead of
      retrying unboundedly
    - ``deadline``: total wall-clock budget in seconds; a retry whose
      backoff sleep would overshoot the deadline raises instead
    - ``jitter``: on by default — DECORRELATED jitter: each sleep is
      ``uniform(backoff, 3 * previous_sleep)`` capped at ``max_backoff``,
      so N workers retrying after one gang-wide incident (say, every
      survivor re-rendezvousing at once) spread out instead of hammering
      the coordinator in lockstep at the same exponential marks.  Falsy
      disables it (deterministic exponential — what the timing tests
      pin); a float keeps the legacy proportional scheme
      (``exponential * (1 + jitter * U[0,1))``).
    - ``retryable``/``non_retryable``: exception classes to retry / to
      re-raise immediately (non_retryable wins)
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
    """Retry a record/file open with the MXTPU_IO_* env plane.

    Missing files are NOT retried (a local ENOENT is deterministic); any
    other OSError — the flaky-NFS/FUSE class — is.
    """
    retries = int(os.environ.get("MXTPU_IO_RETRIES", "2"))
    backoff = float(os.environ.get("MXTPU_IO_BACKOFF", "0.05"))

    def attempt():
        inject_failure("io_open")
        return fn()

    return retry_call(attempt, retries=retries, backoff=backoff,
                      retryable=(OSError, InjectedFault),
                      non_retryable=(FileNotFoundError,),
                      description=description or "io open")


# -- watchdog ------------------------------------------------------------------

def dump_thread_stacks(stream=None, reason=""):
    """Write every Python thread's current stack to ``stream`` (stderr).

    The post-mortem for a wedged process: WHERE each thread is blocked,
    not just that it is.
    """
    stream = stream or sys.stderr
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = [f"==== thread stack dump"
             f"{' (' + reason + ')' if reason else ''} ====\n"]
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} "
                     f"(ident {ident}) ---\n")
        lines.extend(traceback.format_stack(frame))
    lines.append("==== end stack dump ====\n")
    try:
        stream.write("".join(lines))
        stream.flush()
    except Exception:
        pass


class Watchdog:
    """Heartbeat watchdog armed around blocking device work.

    ::

        with Watchdog(60, name="allreduce"):
            kv.pushpull(...)          # raises WatchdogExpired if > 60s

    On expiry the watchdog thread dumps all Python thread stacks, calls
    ``on_expire`` (if given), then applies ``action``:

    - ``"interrupt"``: raise in the main thread (via interrupt_main).
      Breaks python-level blocking (sleep, socket waits); a C call that
      never returns to the interpreter will NOT see it.
    - ``"abort"``: ``os._exit(exit_code)`` — the only reliable escape
      from a wedged C extension call.
      The stack dump has already landed on ``stream`` by then.
    - ``"none"``: only dump + ``on_expire`` (e.g. kill a child process
      the caller is ``communicate()``-ing with).

    ``feed()`` resets the deadline (heartbeat); ``cancel()`` disarms.
    """

    def __init__(self, timeout, name="watchdog", action=None,
                 on_expire=None, exit_code=None, stream=None,
                 dump_stacks=True):
        self.timeout = float(timeout)
        self.name = name
        self.action = action or os.environ.get(
            "MXTPU_WATCHDOG_ACTION", "interrupt")
        if self.action not in ("interrupt", "abort", "none"):
            raise MXNetError(f"Watchdog: unknown action {self.action!r}")
        self.on_expire = on_expire
        self.exit_code = int(
            os.environ.get("MXTPU_WATCHDOG_EXIT_CODE", 124)
            if exit_code is None else exit_code)
        self.stream = stream
        self.dump_stacks = dump_stacks
        self.expired = False
        self._deadline = None
        self._wake = threading.Event()
        self._cancelled = False
        self._thread = None

    # -- lifecycle -------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._deadline = time.monotonic() + self.timeout
        self._thread = threading.Thread(
            target=self._watch, name=f"watchdog:{self.name}", daemon=True)
        self._thread.start()
        return self

    def feed(self):
        """Heartbeat: push the deadline out by ``timeout`` from now."""
        self._deadline = time.monotonic() + self.timeout

    def cancel(self):
        self._cancelled = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def _watch(self):
        while not self._cancelled:
            remaining = self._deadline - time.monotonic()
            if remaining > 0:
                self._wake.wait(timeout=remaining)
                continue
            # deadline passed without a feed/cancel
            self.expired = True
            stream = self.stream or sys.stderr
            try:
                stream.write(
                    f"[resilience] watchdog '{self.name}' expired after "
                    f"{self.timeout:.1f}s (action={self.action})\n")
                stream.flush()
            except Exception:
                pass
            try:
                _tel_event("watchdog_expired", name=self.name,
                           timeout_s=self.timeout, action=self.action)
            except Exception:
                pass
            if self.dump_stacks:
                dump_thread_stacks(stream,
                                   reason=f"watchdog {self.name}")
            if self.on_expire is not None:
                try:
                    self.on_expire()
                except Exception:
                    traceback.print_exc()
            if self.action == "abort":
                os._exit(self.exit_code)
            elif self.action == "interrupt":
                # pthread_kill EINTRs a main thread blocked in a syscall
                # (time.sleep, socket waits) — interrupt_main() alone only
                # sets a flag checked at the NEXT bytecode, which a
                # blocking call never reaches
                try:
                    signal.pthread_kill(threading.main_thread().ident,
                                        signal.SIGINT)
                except (AttributeError, ValueError, OSError):
                    import _thread

                    _thread.interrupt_main()
            return

    # -- context manager -------------------------------------------------------
    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.cancel()
        if self.expired and self.action == "interrupt":
            # translate the injected KeyboardInterrupt (or whatever it
            # landed in) into a structured error
            raise WatchdogExpired(
                f"'{self.name}' exceeded {self.timeout:.1f}s watchdog "
                f"deadline (thread stacks dumped)") from exc
        return False


@contextlib.contextmanager
def _env_watchdog(env_var, name):
    """Arm a Watchdog if the env var sets a timeout; no-op otherwise."""
    timeout = os.environ.get(env_var)
    if not timeout:
        yield None
        return
    with Watchdog(float(timeout), name=name) as wd:
        yield wd


@contextlib.contextmanager
def guard_collective(name="collective"):
    """Guard an eager cross-process collective (kvstore all-reduce,
    distributed.barrier): watchdog from MXTPU_COLLECTIVE_TIMEOUT plus the
    ``stall_collective`` fault-injection point."""
    with _env_watchdog("MXTPU_COLLECTIVE_TIMEOUT", name):
        maybe_stall("stall_collective")
        yield


@contextlib.contextmanager
def guard_step(name="train_step"):
    """Guard one compiled-step dispatch (MXTPU_STEP_TIMEOUT)."""
    with _env_watchdog("MXTPU_STEP_TIMEOUT", name):
        yield


@contextlib.contextmanager
def guard_checkpoint(name="checkpoint"):
    """Guard a checkpoint save/restore (MXTPU_CKPT_TIMEOUT, unset = off):
    a hung filesystem dumps every thread's stack instead of wedging the
    run silently."""
    with _env_watchdog("MXTPU_CKPT_TIMEOUT", name):
        yield


# -- local checkpointer --------------------------------------------------------

_CKPT_MAGIC = b"MXTCKPT1"


#: version of the data-pipeline-state stamp wrapper (the inner state
#: dict carries its own ``gluon/data/state.py`` version independently)
_DATA_STATE_STAMP_VERSION = 1


def data_state_stamp(sd):
    """Wrap a data-pipeline ``state_dict`` (gluon/data/state.py) for the
    checkpoint path: versioned + CRC over the canonical JSON encoding.
    The stamp rides MANIFEST.json / peer-snapshot frames / the
    LocalCheckpointer sidecar as an OPTIONAL key — absent on runs that
    never attached a resumable loader, and old readers ignore it."""
    payload = json.dumps(sd, sort_keys=True, separators=(",", ":"))
    return {"version": _DATA_STATE_STAMP_VERSION,
            "crc": zlib.crc32(payload.encode()) & 0xffffffff,
            "state": sd}


def data_state_unstamp(stamp):
    """Validate + unwrap a :func:`data_state_stamp`.  Lenient on absence
    (None in, None out — pre-PR-19 checkpoints restore fine without a
    data position) but fail-closed on damage: a CRC/version mismatch
    raises CheckpointCorrupt rather than silently mis-aligning the
    sample stream."""
    if stamp is None:
        return None
    if not isinstance(stamp, dict) or "state" not in stamp:
        raise CheckpointCorrupt(
            f"data-pipeline state stamp malformed: {type(stamp).__name__}")
    if stamp.get("version") != _DATA_STATE_STAMP_VERSION:
        raise CheckpointCorrupt(
            f"data-pipeline state stamp version "
            f"{stamp.get('version')!r} (this build reads "
            f"{_DATA_STATE_STAMP_VERSION})")
    sd = stamp["state"]
    payload = json.dumps(sd, sort_keys=True, separators=(",", ":"))
    if zlib.crc32(payload.encode()) & 0xffffffff != stamp.get("crc"):
        raise CheckpointCorrupt(
            "data-pipeline state stamp: checksum mismatch")
    return sd


class LocalCheckpointer:
    """Single-host checkpoints with CRC-verified atomic writes.

    The same save/restore/latest_step/all_steps/wait surface as
    ``checkpoint.AsyncCheckpointer`` so :func:`run_resilient` composes
    with either; this one is synchronous and is what the hermetic
    fault tests (and single-host users) run.

    Format: ``MXTCKPT1 | crc32:u32 | length:u64 | pickle(state)`` written
    to a temp file and atomically renamed — a crash mid-write can never
    leave a half-written file under a valid name, and a corrupt/partial
    file fails closed via the checksum.
    """

    def __init__(self, directory, max_to_keep=3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step):
        return os.path.join(self._dir, f"ckpt_{int(step):010d}.mxtckpt")

    def _data_path(self, step):
        return os.path.join(self._dir,
                            f"ckpt_{int(step):010d}.datastate.json")

    @staticmethod
    def _to_host(state):
        """Device arrays pickle as numpy (a restored checkpoint must not
        depend on the dying process's device layout)."""
        import numpy as np

        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                out = [conv(x) for x in v]
                return out if isinstance(v, list) else tuple(out)
            if hasattr(v, "__array__"):
                return np.asarray(v)
            return v

        return conv(state)

    def save(self, step, state, data_state=None):
        payload = pickle.dumps(self._to_host(state), protocol=4)
        header = _CKPT_MAGIC + struct.pack(
            "<IQ", zlib.crc32(payload) & 0xffffffff, len(payload))
        tmp = self._path(step) + ".tmp"
        with guard_checkpoint(f"ckpt_save:{step}"):
            if data_state is not None:
                # sidecar FIRST, so the .mxtckpt rename (the commit
                # point) never exposes a checkpoint whose data position
                # is still being written
                dtmp = self._data_path(step) + ".tmp"
                with open(dtmp, "w") as f:
                    json.dump(data_state_stamp(data_state), f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(dtmp, self._data_path(step))
            with open(tmp, "wb") as f:
                f.write(header)
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
            # durability: the rename lives in the directory inode — fsync
            # it too, or power loss can roll the commit back
            fsync_dir(self._dir)
        if consume_charges("corrupt_ckpt_write", on_last=False):
            # bit-rot the file AFTER the commit rename: only the
            # verify-after-write readback (_save_verified) can catch it
            with open(self._path(step), "r+b") as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))
        self._prune()
        return step

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            for path in (self._path(s), self._data_path(s)):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def data_state(self, step=None):
        """The data-pipeline state saved alongside ``step`` (latest when
        None), or None when the checkpoint predates resumable loading —
        lenient on absence, fail-closed (CheckpointCorrupt) on a
        damaged stamp."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        try:
            with open(self._data_path(step)) as f:
                stamp = json.load(f)
        except FileNotFoundError:
            return None
        except ValueError as e:
            raise CheckpointCorrupt(
                f"{self._data_path(step)}: unparseable ({e})") from e
        return data_state_unstamp(stamp)

    def restore(self, step=None, template=None):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise MXNetError(f"no checkpoints under {self._dir}")
        path = self._path(step)

        def read():
            with open(path, "rb") as f:
                return f.read()

        with guard_checkpoint(f"ckpt_restore:{step}"):
            blob = io_retry(read, description=f"read {path}")
        if len(blob) < len(_CKPT_MAGIC) + 12 or \
                not blob.startswith(_CKPT_MAGIC):
            raise CheckpointCorrupt(f"{path}: bad checkpoint magic")
        crc, length = struct.unpack(
            "<IQ", blob[len(_CKPT_MAGIC):len(_CKPT_MAGIC) + 12])
        payload = blob[len(_CKPT_MAGIC) + 12:]
        if len(payload) != length:
            raise CheckpointCorrupt(
                f"{path}: truncated (want {length} payload bytes, have "
                f"{len(payload)})")
        if zlib.crc32(payload) & 0xffffffff != crc:
            raise CheckpointCorrupt(f"{path}: checksum mismatch")
        return pickle.loads(payload)

    def verify(self, step):
        """Re-read and checksum a written checkpoint (verify-after-write).
        Raises CheckpointCorrupt on any mismatch."""
        self.restore(step)

    def all_steps(self):
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith("ckpt_") and name.endswith(".mxtckpt"):
                try:
                    steps.append(int(name[5:-8]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        pass

    def close(self):
        pass


# -- resilient training loop ---------------------------------------------------

class RunReport:
    """What :func:`run_resilient` did: where it resumed, how many
    restarts it burned, and the per-step loss trajectory."""

    def __init__(self):
        self.final_step = 0
        self.restarts = 0
        self.reshapes = 0        # elastic gang membership changes
        self.resumed_from = []   # checkpoint step of each (re)start
        self.losses = {}         # step -> float loss
        self.preempted = False

    def __repr__(self):
        return (f"RunReport(final_step={self.final_step}, "
                f"restarts={self.restarts}, reshapes={self.reshapes}, "
                f"resumed_from={self.resumed_from}, "
                f"preempted={self.preempted})")


def flush_inflight(checkpointer, logger=None):
    """Drain an async checkpointer's in-flight save at a recovery point.

    A failed background commit must not abort recovery — the previous
    checkpoint is still valid, which is the whole point of the two-phase
    commit — so errors are logged and swallowed here (they would have
    been raised from the next ``save()`` anyway).
    """
    wait = getattr(checkpointer, "wait", None)
    if wait is None:
        return
    pending = getattr(checkpointer, "pending_step", None)
    try:
        wait()
    except Exception as e:                      # noqa: BLE001
        _log(logger, f"in-flight checkpoint save failed ({e}); "
                     f"recovering from the previous checkpoint")
        _tel_event("inflight_save_dropped",
                   step=int(pending) if isinstance(pending, int) else None,
                   reason=type(e).__name__)


def resume_latest(checkpointer, set_state, logger=None):
    """Restore the newest VALID checkpoint; corrupt/partial ones fall
    back to the previous step.  Returns the restored step (0 = fresh).
    Any in-flight async save is drained first so a commit racing the
    restore can't be half-observed."""
    flush_inflight(checkpointer, logger)
    steps = sorted(checkpointer.all_steps(), reverse=True) \
        if hasattr(checkpointer, "all_steps") else \
        ([checkpointer.latest_step()]
         if checkpointer.latest_step() is not None else [])
    for step in steps:
        try:
            state = checkpointer.restore(step)
        except Exception as e:
            _log(logger, f"checkpoint step {step} unreadable ({e}); "
                         f"falling back to the previous one")
            _tel_event("ckpt_fallback", step=int(step),
                       reason=type(e).__name__)
            continue
        set_state(state)
        _log(logger, f"resumed from checkpoint step {step}")
        return step
    return 0


def _log(logger, msg):
    if logger is None:
        sys.stderr.write(f"[resilience] {msg}\n")
    else:
        logger.info(msg)


def _save_verified(checkpointer, step, state, logger=None,
                   data_state=None):
    """Save + verify-after-write; one rewrite attempt on a bad readback."""
    for attempt in range(2):
        if data_state is not None:
            checkpointer.save(step, state, data_state=data_state)
        else:
            checkpointer.save(step, state)
        checkpointer.wait()
        verify = getattr(checkpointer, "verify", None)
        if verify is None:
            return
        try:
            verify(step)
            return
        except CheckpointCorrupt as e:
            if attempt:
                raise
            _log(logger, f"checkpoint step {step} failed verification "
                         f"({e}); rewriting once")


def run_resilient(step_fn, checkpointer, num_steps, *, get_state,
                  set_state, checkpoint_every=None, max_restarts=3,
                  watchdog_timeout=None, exit_on_preempt=False,
                  recover_on=(RuntimeError, OSError), logger=None,
                  gang=None, on_reshape=None,
                  get_data_state=None, set_data_state=None):
    """Supervised training loop: auto-resume + preemption checkpointing +
    bounded in-process restarts.

    - ``step_fn(step) -> loss``: run ONE training step (0-based ``step``
      counts completed steps).  Must be a pure function of the current
      training state for crash-resume to reproduce the loss trajectory.
    - ``get_state() -> pytree`` / ``set_state(pytree)``: snapshot/load
      everything a restart needs (params, optimizer state, RNG, ...).
    - ``checkpointer``: LocalCheckpointer / checkpoint.AsyncCheckpointer /
      ShardedCheckpointer surface.  An async engine overlaps the
      serialize+fsync with training (its CRC-verified two-phase commit
      replaces the synchronous verify-after-write) and is drained at
      every recovery point and at the end of the run.
    - ``checkpoint_every``: steps between periodic saves; ``None`` reads
      ``MXTPU_CKPT_EVERY`` (default 25), ``0`` disables.
    - On SIGTERM (a preemption notice) the current state is
      checkpointed; with ``exit_on_preempt`` the loop returns (the
      process is about to die), otherwise the preemption is treated as
      an in-process restart and counted against ``max_restarts`` — the
      hermetic analog of kill-and-relaunch.
    - A step failure in ``recover_on`` (or a watchdog expiry) restores
      the latest valid checkpoint and replays; corrupt checkpoints fall
      back to the previous step.
    - ``gang`` / ``on_reshape`` (elastic recovery across processes)
      come with the gang slice: passing a gang raises
      ``NotImplementedError``.
    - ``get_data_state() -> dict`` / ``set_data_state(dict)``: the input
      pipeline's position (``DataLoader.state_dict`` /
      ``load_state_dict``, gluon/data/state.py).  Saved alongside every
      checkpoint (MANIFEST.json stamp or LocalCheckpointer sidecar) and
      re-adopted leniently at every resume point, so the sample stream rewinds in lockstep with the
      trainer state: zero re-read, zero skipped samples.

    Returns a :class:`RunReport`.
    """
    from .checkpoint import PreemptionHandler

    if gang is not None or on_reshape is not None:
        raise NotImplementedError(
            "run_resilient(gang=...): elastic gang recovery comes with the "
            "gang slice")
    if checkpoint_every is None:
        checkpoint_every = int(os.environ.get("MXTPU_CKPT_EVERY", 25))
    # async engines own crash consistency via the two-phase commit; the
    # synchronous readback verify would serialize the save we just made
    # asynchronous
    is_async = bool(getattr(checkpointer, "async_save", False))

    def save_at(step):
        ds = None
        if get_data_state is not None and \
                hasattr(checkpointer, "data_state"):
            ds = get_data_state()
        if is_async:
            if ds is not None:
                checkpointer.save(step, get_state(), data_state=ds)
            else:
                checkpointer.save(step, get_state())
        else:
            _save_verified(checkpointer, step, get_state(), logger,
                           data_state=ds)

    def adopt_data_state(step):
        """Rewind the input pipeline to the restored step's position —
        lenient when the checkpoint carries none (pre-data-state
        manifests, fresh starts)."""
        if set_data_state is None or not step:
            return
        ds_fn = getattr(checkpointer, "data_state", None)
        ds = ds_fn(step) if ds_fn is not None else None
        if ds is not None:
            set_data_state(ds)

    report = RunReport()
    step = resume_latest(checkpointer, set_state, logger)
    adopt_data_state(step)
    report.resumed_from.append(step)
    _tel_event("resume", step=step)
    last_saved = step
    step_box = [step]

    with PreemptionHandler(checkpointer, get_state,
                           lambda: step_box[0]) as handler:
        while step < num_steps:
            step_box[0] = step
            # fault injection: deliver a real SIGTERM to ourselves at
            # step S — exercises the whole preemption path
            if fault_arg("sigterm_at_step") == step and \
                    consume_fault("sigterm_at_step"):
                os.kill(os.getpid(), signal.SIGTERM)
            if handler.preempted.is_set():
                handler.maybe_checkpoint()   # saves at current step
                last_saved = step
                report.preempted = True
                if exit_on_preempt:
                    report.final_step = step
                    return report
                if report.restarts >= max_restarts:
                    raise MXNetError(
                        f"run_resilient: preempted with no restarts left "
                        f"(max_restarts={max_restarts})")
                report.restarts += 1
                handler.preempted.clear()
                step = resume_latest(checkpointer, set_state, logger)
                adopt_data_state(step)
                report.resumed_from.append(step)
                _tel_event("restart", step=step, reason="preempted")
                continue
            try:
                if watchdog_timeout:
                    with Watchdog(watchdog_timeout,
                                  name=f"step {step}"):
                        loss = step_fn(step)
                else:
                    loss = step_fn(step)
            except recover_on as e:
                if report.restarts >= max_restarts:
                    raise
                report.restarts += 1
                _log(logger, f"step {step} failed ({type(e).__name__}: "
                             f"{e}); restart "
                             f"{report.restarts}/{max_restarts}")
                reason = type(e).__name__
                step = resume_latest(checkpointer, set_state, logger)
                adopt_data_state(step)
                report.resumed_from.append(step)
                _tel_event("restart", step=step, reason=reason)
                continue
            if loss is not None:
                try:
                    report.losses[step] = float(loss)
                except (TypeError, ValueError):
                    pass
            step += 1
            if checkpoint_every and step % checkpoint_every == 0:
                save_at(step)
                last_saved = step
        if step > last_saved:
            save_at(step)
        if is_async:
            checkpointer.wait()   # the final commit must land before we
    report.final_step = step      # report the run finished
    return report


# -- the gang half's pieces a one-process run uses ------------------------------
#
# The failure exceptions and the heartbeat plane: the serving replicas and
# their front door run on them over a FileKV.  The gang itself
# (ElasticGang, StragglerMonitor, ScalePolicy) comes with the gang slice.

class RankFailure(MXNetError):
    """A gang membership change is required: peers confirmed dead and/or
    respawned ranks asking to rejoin.  Raised by `ElasticGang.step_tick`
    (and gang barriers); the handler calls `ElasticGang.recover`."""

    def __init__(self, dead, epoch, joiners=(), planned=False,
                 at_step=None):
        self.dead = sorted(dead)
        self.joiners = sorted(joiners)
        self.epoch = int(epoch)
        self.at_step = at_step         # planned reshape's agreed step
        self.planned = bool(planned)   # scheduled drain/admit, nobody
        what = []                      # actually died — no detection
        if self.dead:                  # window, zero lost steps
            what.append(f"{'leaving' if planned else 'dead'} ranks "
                        f"{self.dead}")
        if self.joiners:
            what.append(f"join requests {self.joiners}")
        super().__init__(
            f"gang membership change at epoch {epoch}"
            f"{' (planned)' if planned else ''}: "
            f"{', '.join(what) or 'unknown'}")


class GangEvicted(MXNetError):
    """The agreed epoch excludes THIS rank — the survivors declared it
    dead (a wedge that later unwedged, a partition, a false positive).
    The only safe move is a clean exit: rejoining with stale state would
    corrupt the reshaped gang.  Workers treat this as exit code 0."""


class GangFenced(MXNetError):
    """This rank is on the WRONG side of a partition (or cannot reach a
    quorum of the previous epoch's members): it must not step, must not
    commit anything durable, and must not propose an epoch.  Unlike
    `GangEvicted` this is recoverable — the rank keeps heartbeating,
    parks in `ElasticGang.park_fenced`, and rejoins via `join_req` when
    the partition heals, adopting the majority's state instead of its
    own.  Raised by `step_tick`/`recover` when the KV is unreachable or
    a reshape deadline passes without a strict majority of the previous
    epoch acking."""

    def __init__(self, reason, epoch=None):
        self.reason = str(reason)
        self.epoch = epoch
        super().__init__(
            f"gang fenced at epoch {epoch}: {reason}" if epoch is not None
            else f"gang fenced: {reason}")


class HeartbeatPublisher:
    """Per-rank liveness beacon: a daemon thread publishes
    ``hb/<rank> = {rank, seq, step, t}`` to the gang KV every
    ``MXTPU_HEARTBEAT_INTERVAL`` (0.5s).  ``seq`` is what the failure
    detector watches — strictly monotonic per publish, so a stalled
    clock or republished file can't fake liveness.  ``note_step`` keeps
    the payload's step id fresh (the straggler monitor's lag signal).

    The ``heartbeat_loss:K`` fault site suppresses publishing while the
    process keeps running: the wedged-but-alive failure mode, which must
    look exactly like death to the detector.
    """

    def __init__(self, kv, rank, interval=None):
        self.kv = kv
        self.rank = int(rank)
        self.interval = float(
            os.environ.get("MXTPU_HEARTBEAT_INTERVAL", 0.5)
            if interval is None else interval)
        self._step = 0
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None

    def note_step(self, step):
        self._step = int(step)

    def publish_once(self):
        if self.rank in fault_args("heartbeat_loss"):
            return
        self._seq += 1
        self.kv.put_json(f"hb/{self.rank}",
                         {"rank": self.rank, "seq": self._seq,
                          "step": self._step, "t": time.time()})

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.publish_once()
            except Exception:       # noqa: BLE001 — liveness reporting
                pass                # must never kill training
            self._stop.wait(self.interval)

    def start(self):
        if self._thread is None:
            self.publish_once()     # visible before the first interval
            self._thread = threading.Thread(
                target=self._loop, name=f"heartbeat:{self.rank}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class _PeerHealth:
    __slots__ = ("seq", "step", "last_change", "arrivals", "suspected")

    def __init__(self, now):
        self.seq = None
        self.step = None
        self.last_change = now
        self.arrivals = collections.deque(maxlen=32)
        self.suspected = False


class FailureDetector:
    """Phi-style accrual failure detector over KV heartbeats.

    Suspicion is *accrual*: phi = silence / mean-observed-interarrival,
    so a peer that heartbeats every 0.1s is suspected after ~1s of
    silence while a peer on a slow NFS gang dir isn't — the threshold
    adapts to each peer's own cadence (``MXTPU_PHI_SUSPECT``, 8.0).
    Suspicion only emits a ``rank_suspected`` telemetry event (once per
    silence episode); *death* is confirmed by the hard wall-clock
    timeout ``MXTPU_HEARTBEAT_TIMEOUT`` (5s), which is what the reshape
    protocol acts on — a deliberately conservative two-level scheme so
    one GC pause can't trigger a reshard.

    ``poll()`` is throttled to ``check_interval`` (half the heartbeat
    interval), so calling it every training step costs a dict lookup,
    not a KV scan.
    """

    def __init__(self, kv, rank, peers, *, timeout=None,
                 suspect_phi=None, check_interval=None):
        self.kv = kv
        self.rank = int(rank)
        self.timeout = float(
            os.environ.get("MXTPU_HEARTBEAT_TIMEOUT", 5.0)
            if timeout is None else timeout)
        self.suspect_phi = float(
            os.environ.get("MXTPU_PHI_SUSPECT", 8.0)
            if suspect_phi is None else suspect_phi)
        if check_interval is None:
            check_interval = float(
                os.environ.get("MXTPU_HEARTBEAT_INTERVAL", 0.5)) / 2.0
        self.check_interval = max(1e-3, float(check_interval))
        self._peers = {}
        now = time.monotonic()
        for p in peers:
            if int(p) != self.rank:
                self._peers[int(p)] = _PeerHealth(now)
        self._last_check = 0.0
        self._dead = set()

    def watch(self, rank):
        if int(rank) != self.rank and int(rank) not in self._peers:
            self._peers[int(rank)] = _PeerHealth(time.monotonic())
        self._dead.discard(int(rank))

    def forget(self, rank):
        self._peers.pop(int(rank), None)
        self._dead.discard(int(rank))

    def peer_steps(self):
        """Last heartbeat-published step id per watched peer (None until
        the first heartbeat lands)."""
        return {p: h.step for p, h in self._peers.items()}

    def poll(self, force=False):
        """Returns the set of CONFIRMED-dead peers (silence beyond the
        hard timeout).  Throttled; pass force=True to re-read the KV
        regardless (recovery paths)."""
        now = time.monotonic()
        if not force and now - self._last_check < self.check_interval:
            return set(self._dead)
        self._last_check = now
        for p, h in self._peers.items():
            rec = self.kv.get_json(f"hb/{p}")
            seq = rec.get("seq") if isinstance(rec, dict) else None
            if seq is not None and seq != h.seq:
                if h.seq is not None:
                    h.arrivals.append(now - h.last_change)
                h.seq = seq
                h.step = rec.get("step")
                h.last_change = now
                h.suspected = False
                self._dead.discard(p)
                continue
            silence = now - h.last_change
            mean = (sum(h.arrivals) / len(h.arrivals)) \
                if h.arrivals else None
            phi = silence / mean if mean else 0.0
            if not h.suspected and (phi >= self.suspect_phi
                                    or silence >= self.timeout / 2.0):
                h.suspected = True
                _tel_event("rank_suspected", rank=p,
                           silence_s=round(silence, 3),
                           phi=round(phi, 2))
            if silence >= self.timeout:
                self._dead.add(p)
        return set(self._dead)


def announce_freed_chips(kv, rank, *, step=None, count=1, addr=None):
    """Publish that ``rank``'s chips are free (post-drain): the serving
    tier's FleetWatcher claims ``chips/freed/<rank>`` and spawns a
    replica on them — one elastically partitioned mesh shared by
    training and serving."""
    rec = {"rank": int(rank), "count": int(count), "t": time.time()}
    if step is not None:
        rec["step"] = int(step)
    if addr is not None:
        rec["addr"] = addr
    kv.put_json(f"chips/freed/{rank}", rec)
    _tel_event("chips_freed", rank=int(rank), count=int(count),
               step=step)
    return rec
