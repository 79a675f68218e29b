"""Fault tolerance: retries, watchdogs, the fault-injection harness and
the resilient training loop.

Counterpart of ``mxnet_tpu/resilience.py``.  The failure modes: preemption (SIGTERM with a grace window), corrupt or
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
  and a fallback to the previous checkpoint when the newest is corrupt;
  with ``gang=`` a confirmed peer death reshapes the gang instead.
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

Elastic gang recovery lives here too: :class:`HeartbeatPublisher`,
:class:`FailureDetector` and :class:`StragglerMonitor` form the health
plane over ``distributed.gang_kv()``, :class:`ElasticGang` runs the
epoch-consensus reshape that lets survivors shrink N to M (and grow
back) without restarting the gang, and :class:`ScalePolicy` turns input
saturation and preemption notices into planned admits and drains.  The
gang's settings: ``MXTPU_QUORUM`` (0 lets a minority commit an epoch),
``MXTPU_RESHAPE_TIMEOUT`` (60 s), ``MXTPU_PEER_SNAP_EVERY`` (10 steps),
``MXTPU_PEER_HOST``, ``MXTPU_PEER_SNAP_RETAIN`` (seconds a snapshot is
kept past ``keep``), ``MXTPU_STRAGGLER_WINDOW`` / ``_SHARE``,
``MXTPU_SCALE_*``.  A peer snapshot of state on the card goes through an
attached ``checkpoint.AsyncCheckpointer``'s pinned copy and writer
thread (``attach_peers``), so it holds the train stream no longer than a
save.
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


def _tel_identity(rank=None, world=None):
    """Stamp this process's fleet identity onto telemetry records."""
    from . import telemetry

    telemetry.set_identity(rank=rank, world=world)


def _tel_set_epoch(epoch):
    """Stamp the adopted gang epoch onto telemetry step records."""
    from . import telemetry

    telemetry.set_gang_epoch(int(epoch))


def _tel_count(name, n=1):
    from . import telemetry

    telemetry.count(name, n)


def _gang_kv_errors():
    """Exception classes that mean 'the gang KV is unreachable from this
    rank', the fencing trigger (resolved late: `distributed` imports this
    module)."""
    from . import distributed

    return (distributed.GangKVError, OSError)


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
    - ``gang`` (an :class:`ElasticGang`): gang-level recovery.  Each
      step ticks the health plane (heartbeat step ids, peer snapshots,
      failure-detector poll); a confirmed peer death raises
      :class:`RankFailure`, which runs ``gang.recover`` — survivors
      agree a new epoch and keep training — instead of the full-restart
      path.  ``on_reshape(info)`` merges the recovered per-rank shards
      back into trainer state and returns the resume step (or a
      ``(step, new_checkpointer)`` tuple when the reshape rebuilds the
      checkpoint engine for the new world size); without the callback
      only disk-sourced recoveries (``info.full_state``) can be applied.
    - ``get_data_state() -> dict`` / ``set_data_state(dict)``: the input
      pipeline's position (``DataLoader.state_dict`` /
      ``load_state_dict``, gluon/data/state.py).  Saved alongside every
      checkpoint (MANIFEST.json stamp or LocalCheckpointer sidecar) and
      re-adopted leniently at every resume point — including gang
      reshapes — so the sample stream rewinds in lockstep with the
      trainer state: zero re-read, zero skipped samples.

    Returns a :class:`RunReport`.
    """
    from .checkpoint import PreemptionHandler

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

    def gang_reshape(rf):
        """Shared RankFailure handler (step tick, step fn, or a gang-
        coordinated checkpoint barrier may raise it)."""
        nonlocal step, checkpointer, is_async, last_saved
        info = gang.recover(rf, checkpointer=checkpointer)
        report.reshapes += 1
        if on_reshape is not None:
            res = on_reshape(info)
            if isinstance(res, tuple):
                step, checkpointer = res
            else:
                step = int(res) if res is not None else info.snap_step
        elif info.full_state is not None:
            set_state(info.full_state)
            step = info.snap_step
        else:
            raise MXNetError(
                "run_resilient: gang recovery assembled per-rank peer "
                "shards; pass on_reshape= to merge them into trainer "
                "state") from rf
        is_async = bool(getattr(checkpointer, "async_save", False))
        adopt_data_state(step)
        last_saved = step
        step_box[0] = step
        report.resumed_from.append(step)
        _log(logger, f"gang reshaped to epoch {info.epoch} (world "
                     f"{info.world}); resuming at step {step}")

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
                if gang is not None:
                    gang.step_tick(step, state_fn=get_state)
                if watchdog_timeout:
                    with Watchdog(watchdog_timeout,
                                  name=f"step {step}"):
                        loss = step_fn(step)
                else:
                    loss = step_fn(step)
            except RankFailure as rf:
                if gang is None:
                    raise
                gang_reshape(rf)
                continue
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
                try:
                    save_at(step)
                except RankFailure as rf:
                    if gang is None:
                        raise
                    gang_reshape(rf)   # a peer died inside the gang-
                    continue           # coordinated commit barrier
                last_saved = step
        if step > last_saved:
            save_at(step)
        if is_async:
            checkpointer.wait()   # the final commit must land before we
    report.final_step = step      # report the run finished
    return report


# -- elastic gang recovery (health plane + membership protocol) ----------------

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


class StragglerMonitor:
    """Names the slow rank behind persistent collective waits.

    Fed the per-step collective-wait share (telemetry StepStats
    ``shares["collective"]``): when the mean share over the last
    ``MXTPU_STRAGGLER_WINDOW`` (20) steps exceeds
    ``MXTPU_STRAGGLER_SHARE`` (0.5), this rank is mostly waiting for a
    peer — and the peer whose heartbeat-published step id is furthest
    behind is the one everyone is waiting on.  Emits a
    ``straggler_suspected`` event (at most once per window) naming it;
    detection only — eviction stays a human/provisioner decision, since
    a straggler still makes progress.
    """

    def __init__(self, detector, *, window=None, share_threshold=None):
        self.detector = detector
        self.window = int(os.environ.get("MXTPU_STRAGGLER_WINDOW", 20)
                          if window is None else window)
        self.share_threshold = float(
            os.environ.get("MXTPU_STRAGGLER_SHARE", 0.5)
            if share_threshold is None else share_threshold)
        self._shares = collections.deque(maxlen=max(1, self.window))
        self._last_emit_step = None

    def observe(self, step, collective_share):
        """Returns the suspected rank when one is (newly) named."""
        if collective_share is None:
            return None
        self._shares.append(float(collective_share))
        if len(self._shares) < self.window:
            return None
        mean = sum(self._shares) / len(self._shares)
        if mean < self.share_threshold:
            return None
        if self._last_emit_step is not None and \
                step - self._last_emit_step < self.window:
            return None
        steps = {p: s for p, s in self.detector.peer_steps().items()
                 if s is not None and s <= step}
        if not steps:
            return None
        laggard = min(steps, key=steps.get)
        self._last_emit_step = step
        _tel_event("straggler_suspected", rank=laggard, step=int(step),
                   mean_collective_share=round(mean, 3),
                   laggard_step=int(steps[laggard]))
        return laggard


class RecoveryInfo:
    """What `ElasticGang.recover` agreed and assembled."""

    def __init__(self, *, epoch, members, snap_step, source, dead,
                 joined, recovery_ms, shards=None, full_state=None,
                 old_members=(), planned=False):
        self.epoch = int(epoch)
        self.members = list(members)
        self.snap_step = int(snap_step)
        self.source = source            # "peer" | "disk"
        self.dead = sorted(dead)
        self.joined = sorted(joined)
        self.recovery_ms = float(recovery_ms)
        self.shards = shards            # {old_rank: shard state} (peer)
        self.full_state = full_state    # full pytree (disk)
        self.old_members = list(old_members)
        self.planned = bool(planned)    # drain/admit, not a death

    @property
    def world(self):
        return len(self.members)

    def __repr__(self):
        return (f"RecoveryInfo(epoch={self.epoch}, "
                f"members={self.members}, snap_step={self.snap_step}, "
                f"source={self.source!r}, dead={self.dead}, "
                f"joined={self.joined}, "
                f"recovery_ms={self.recovery_ms:.1f})")


class ElasticGang:
    """The elastic membership runtime one rank participates in.

    Composes the health plane (heartbeats out, failure detection in,
    straggler naming) with peer-replicated RAM snapshots
    (`checkpoint.PeerSnapshotStore`) and the epoch-consensus reshape
    protocol.  The control plane is `distributed.gang_kv()` — a shared
    directory (``MXTPU_GANG_DIR``), a ``GangKVServer`` or the process
    group's store —
    chosen for exactly one property the collective plane lacks: it
    keeps working while a member is dead.

    Protocol sketch::

        steady state   every rank:  hb/<r> <- {seq, step}        (0.5 s)
                       every PEER_SNAP_EVERY steps:
                           own shard -> buddy's RAM  (+ hold own)
                           snap/<r> <- {step, epoch}
        death          detector: silence(hb/<k>) > TIMEOUT
                       survivors raise RankFailure -> recover():
                         min(survivors) proposes epoch/current <-
                           {epoch+1, members, dead, snap_step, source}
                         all new members ack epoch_ack/<e>/<r>
                         shards assembled: own RAM + live peers' RAM +
                           dead ranks' shards from their buddies' RAM;
                           disk manifest only when a buddy died
                       training resumes at snap_step, epoch e+1
        rejoin         respawned rank: join_req/<r>; proposer admits at
                       the next epoch; everyone rolls back to the agreed
                       snapshot, joiner fetches all shards from peers

    ``step_tick`` raises :class:`RankFailure` (membership change needed)
    or :class:`GangEvicted` (this rank was declared dead); the caller —
    `run_resilient(gang=...)` or a bespoke train loop — runs
    ``recover`` and continues from the returned :class:`RecoveryInfo`.
    """

    def __init__(self, rank, world, *, kv=None, peers=None,
                 heartbeat_interval=None, heartbeat_timeout=None,
                 peer_snap_every=None, reshape_timeout=None,
                 checkpointer=None):
        if kv is None:
            from . import distributed

            kv = distributed.gang_kv()
        if kv is None:
            raise MXNetError(
                "ElasticGang needs a control plane: set MXTPU_GANG_DIR "
                "to a shared directory (or run under a coordination "
                "service)")
        self.kv = kv
        self.rank = int(rank)
        self.members = list(range(int(world)))
        self.epoch = 0
        _tel_identity(rank=self.rank, world=len(self.members))
        self.checkpointer = checkpointer
        # quorum-gated reshape (split-brain safety): an epoch commit
        # needs acks from a STRICT majority of the previous epoch's
        # members — dead ranks count against, not for.  MXTPU_QUORUM=0
        # is the force-new-cluster escape hatch for deliberate
        # minority-survivor restarts (e.g. 3->1 disk fallback).
        self._quorum = os.environ.get("MXTPU_QUORUM", "1").lower() \
            not in ("0", "false", "")
        self._fenced_at = None
        if self.checkpointer is not None:
            attach = getattr(self.checkpointer, "attach_gang", None)
            if attach is not None:
                attach(lambda: self.epoch, self._committed_epoch)
        self.peer_snap_every = int(
            os.environ.get("MXTPU_PEER_SNAP_EVERY", 10)
            if peer_snap_every is None else peer_snap_every)
        self.reshape_timeout = float(
            os.environ.get("MXTPU_RESHAPE_TIMEOUT", 60.0)
            if reshape_timeout is None else reshape_timeout)
        # steps of notice a planned reshape (drain/admit) gives the
        # gang: every member must tick the agreed step AFTER the plan
        # lands, so it must exceed the worst lockstep skew (1 step)
        self.drain_margin = max(
            2, int(os.environ.get("MXTPU_SCALE_MARGIN", 2)))
        self.hb = HeartbeatPublisher(kv, rank,
                                     interval=heartbeat_interval)
        self.detector = FailureDetector(kv, rank, self.members,
                                        timeout=heartbeat_timeout)
        self.straggler = StragglerMonitor(self.detector)
        if peers is None:
            from .checkpoint import PeerSnapshotStore

            peers = PeerSnapshotStore(rank, kv=kv)
        self.peers = peers
        self._last_snap_step = None
        self._started = False
        self._group_formed = False     # form_process_group ran

    # -- membership helpers ----------------------------------------------------

    def buddy_of(self, rank, members=None):
        """The next member ring-wise — who holds ``rank``'s RAM shard."""
        m = members if members is not None else self.members
        i = m.index(rank)
        return m[(i + 1) % len(m)]

    def _is_proposer(self, survivors=None):
        alive = survivors if survivors is not None else self.members
        return alive and self.rank == min(alive)

    # -- fencing helpers -------------------------------------------------------

    def _committed_epoch(self):
        """Highest committed epoch: the KV's fence when it keeps one,
        else the ``epoch/current`` record.  Raises when the KV is
        unreachable (a partitioned caller must treat that as stale)."""
        ce = getattr(self.kv, "committed_epoch", None)
        if ce is not None:
            return int(ce())
        cur = self.kv.get_json("epoch/current")
        return int(cur.get("epoch", 0)) if cur else 0

    def _fence_to(self, epoch):
        """Propagate the adopted epoch to every durable-write plane:
        telemetry step records (schema v8 ``gang_epoch``) and the peer
        snapshot receiver's frame fence."""
        _tel_set_epoch(epoch)
        fence = getattr(self.peers, "fence", None)
        if fence is not None:
            try:
                fence(int(epoch))
            except Exception:       # noqa: BLE001 — best-effort
                pass

    def _fenced(self, reason):
        """Build (and announce) the fenced state: the caller raises the
        returned :class:`GangFenced` and parks in `park_fenced`."""
        if self._fenced_at is None:
            self._fenced_at = time.monotonic()
        _tel_event("gang_fenced", rank=self.rank, epoch=self.epoch,
                   reason=str(reason)[:200])
        sys.stderr.write(
            f"[resilience] rank {self.rank}: FENCED at epoch "
            f"{self.epoch}: {reason}\n")
        return GangFenced(reason, epoch=self.epoch)

    def _put_json_fenced(self, key, obj, epoch):
        """Fenced compare-and-swap write when the KV supports it
        (`put_json_if_epoch`), plain put otherwise (CoordKV)."""
        put = getattr(self.kv, "put_json_if_epoch", None)
        if put is None:
            self.kv.put_json(key, obj)
        else:
            put(key, obj, int(epoch))

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        if self._started:
            return self
        self.peers.start()
        cur = self.kv.get_json("epoch/current")
        if cur is None and self._is_proposer():
            self.kv.put_json("epoch/current",
                             {"epoch": 0, "members": self.members,
                              "dead": [], "joined": [],
                              "proposer": self.rank, "t": time.time()})
        elif cur is not None and int(cur.get("epoch", 0)) >= self.epoch \
                and self.rank in cur.get("members", []):
            self.epoch = int(cur["epoch"])
            self.members = list(cur["members"])
            _tel_identity(rank=self.rank, world=len(self.members))
            self.detector = FailureDetector(
                self.kv, self.rank, self.members,
                timeout=self.detector.timeout)
            self.straggler.detector = self.detector
        self._fence_to(self.epoch)
        self.hb.start()
        self._started = True
        return self

    def stop(self):
        self.hb.stop()
        self.peers.close()
        self._started = False

    # -- per-step health tick --------------------------------------------------

    def step_tick(self, step, state=None, state_fn=None,
                  collective_share=None):
        """Call once per training step (cheap: throttled KV reads).

        Publishes the step id, takes the periodic peer snapshot (from
        ``state`` or lazily from ``state_fn()``), feeds the straggler
        monitor, and raises :class:`RankFailure` on a confirmed peer
        death / pending join, :class:`GangEvicted` when a newer epoch
        excludes this rank, or :class:`GangFenced` when the gang KV is
        unreachable (this rank is on the losing side of a partition —
        park in :meth:`park_fenced`).
        """
        maybe_slow_rank(self.rank)
        maybe_kill_rank(self.rank, step)
        maybe_pause_rank(self.rank)
        self.hb.note_step(step)
        try:
            # zombie containment: learn the committed epoch FIRST — a
            # rank resumed after a suspension (SIGSTOP, preemptor
            # pause) must discover its eviction BEFORE the snapshot's
            # durable writes below, not after
            self._check_epoch()
            if self.peer_snap_every and step % self.peer_snap_every == 0 \
                    and step != self._last_snap_step:
                if state is None and state_fn is not None:
                    state = state_fn()
                if state is not None:
                    self.snapshot(step, state)
            self.straggler.observe(step, collective_share)
            plan = self._pending_reshape(step)
            if plan is not None:
                # planned reshape due NOW: snapshot at this exact step
                # so the whole gang shares the restore point (zero lost
                # steps), then reshape with no detection window
                leavers, admits, at_step = plan
                if state is None and state_fn is not None:
                    state = state_fn()
                if state is not None and self._last_snap_step != step:
                    self.snapshot(step, state)
                raise RankFailure(leavers, self.epoch, joiners=admits,
                                  planned=True, at_step=at_step)
            dead = self.detector.poll() & set(self.members)
            dead.discard(self.rank)
            if dead:
                raise RankFailure(dead, self.epoch)
            if self._is_proposer():
                joiners = self._pending_joiners()
                if joiners:
                    self._schedule_admit(step, joiners)
        except _gang_kv_errors() as e:
            raise self._fenced(e) from e

    def snapshot(self, step, state):
        """RAM-replicate this rank's shard of ``state``: hold our own
        copy and ship one to the buddy, then advertise the step in the KV
        so a future proposal can pick a common restore point.

        With an ``AsyncCheckpointer`` that has this gang's store attached
        (``attach_peers``) the copy is ordered there (pinned buffers, side
        stream) and its writer thread packs, holds, sends and advertises;
        an error of that thread (a fenced advert: ``GangEvicted``) comes
        out of the next snapshot.  Otherwise all of it runs here."""
        self._last_snap_step = step
        buddy = self.buddy_of(self.rank)
        ck = self.checkpointer
        if ck is not None and getattr(ck, "_peer_store", None) is \
                self.peers and hasattr(ck, "push_peers"):
            epoch = self.epoch
            ck.push_peers(step, state, buddy, epoch=epoch,
                          after=lambda: self._advertise(step, epoch,
                                                        writer=True))
            return
        blob = self.peers.pack(state)
        self.peers.hold_blob(self.rank, step, blob, epoch=self.epoch)
        if buddy != self.rank:
            self.peers.send_blob(buddy, step, blob, epoch=self.epoch)
        self._advertise(step, self.epoch)

    def _advertise(self, step, epoch, writer=False):
        """Publish ``snap/<rank>`` (fenced at ``epoch``) once the
        snapshot of ``step`` is held, and free departed ranks' shards.
        From the writer thread (``writer``) a fenced advert is dropped:
        the snapshot was taken under an epoch the gang has left, and the
        train thread's next tick meets the newer epoch itself (before any
        durable write), so no error is carried over to a later step."""
        from . import distributed
        try:
            self._put_json_fenced(
                f"snap/{self.rank}",
                {"step": int(step),
                 "steps": self.peers.held_steps(self.rank, epoch=epoch),
                 "epoch": epoch},
                epoch)
        except distributed.FencedWrite:
            if writer:
                return
            # a newer epoch committed while this rank was out to lunch
            # — it is a zombie.  _check_epoch tells the real story
            # (evicted vs still-member-of-newer-epoch); if the record
            # is somehow unreadable, evict conservatively.
            self._check_epoch()
            raise GangEvicted(
                f"rank {self.rank}: snapshot write fenced at epoch "
                f"{epoch} (a newer epoch committed while this "
                f"rank was suspended); exiting cleanly")
        # departed ranks' shards are freed HERE, not in recover():
        # forgetting there races a slower survivor's fetch of the
        # departed rank's shard from this rank's RAM.  Prune only once
        # every current member has signalled end-of-assembly
        # (epoch_done/<e>/<r>, written at the bottom of recover)
        if any(r not in self.members for r in self.peers.held_ranks()):
            done = set()
            for key, _ in self.kv.scan(f"epoch_done/{epoch}"):
                try:
                    done.add(int(key.rsplit("/", 1)[1]))
                except ValueError:
                    pass
            if set(self.members) <= done:
                self.peers.prune_ranks(self.members)

    def _check_epoch(self):
        cur = self.kv.get_json("epoch/current")
        if cur and int(cur.get("epoch", 0)) > self.epoch:
            if self.rank not in cur.get("members", []):
                raise GangEvicted(
                    f"rank {self.rank}: epoch {cur['epoch']} members "
                    f"{cur.get('members')} exclude this rank (declared "
                    f"dead); exiting cleanly")
            raise RankFailure(cur.get("dead", []), self.epoch,
                              joiners=cur.get("joined", []))
        # an epoch still in its ack round (epoch/proposed, uncommitted):
        # members named by it must enter recover() and ack — the quorum
        # gate needs their votes.  A rank the proposal EXCLUDES keeps
        # ticking: its writes carry the old epoch, which stays valid
        # until the commit advances the fence, and an uncommitted
        # proposal (it may never reach quorum) must not evict anyone.
        prop = self.kv.get_json("epoch/proposed")
        if prop and int(prop.get("epoch", 0)) > self.epoch \
                and self.rank in prop.get("members", []):
            raise RankFailure(prop.get("dead", []), self.epoch,
                              joiners=prop.get("joined", []))

    def _pending_joiners(self):
        joiners = []
        for key, _ in self.kv.scan("join_req"):
            rec = self.kv.get_json(key)
            r = rec.get("rank") if isinstance(rec, dict) else None
            if r is not None and r not in self.members:
                joiners.append(int(r))
        return sorted(set(joiners))

    # -- planned reshape (drain / scheduled admit) -----------------------------

    def plan_leave(self, at_step):
        """Schedule this rank's planned departure at ``at_step`` (a
        preemption drain).  Every member — including this rank — keeps
        stepping normally until its own tick of ``at_step``, snapshots
        there, and reshapes; the leaver is excluded from the new epoch
        and exits via :class:`GangEvicted`.  No detection window, no
        lost steps.  ``at_step`` must be at least ``drain_margin``
        steps ahead."""
        at = int(at_step)
        self.kv.put_json(f"leave/{self.rank}",
                         {"rank": self.rank, "at_step": at,
                          "epoch": self.epoch, "t": time.time()})
        _tel_event("gang_drain_scheduled", rank=self.rank, at_step=at,
                   epoch=self.epoch)
        return at

    def _schedule_admit(self, step, joiners):
        """Proposer only: schedule joiners for a planned admit a few
        steps out instead of reshaping immediately — every member then
        snapshots at the same agreed step, so admission loses no
        steps."""
        admit = self.kv.get_json("admit/plan")
        if isinstance(admit, dict) and \
                int(admit.get("epoch", -1)) == self.epoch:
            return      # one pending admit at a time; next epoch
        self.kv.put_json("admit/plan",
                         {"epoch": self.epoch,
                          "at_step": int(step) + self.drain_margin,
                          "joiners": sorted(joiners),
                          "t": time.time()})

    def _pending_reshape(self, step):
        """The planned membership change due at this tick, as
        ``(leavers, joiners, at_step)`` — or None when nothing is due
        yet.  Scheduled leaves and a scheduled admit that fall due
        together reshape in one epoch."""
        leavers, due_at = [], []
        for key, _ in self.kv.scan("leave"):
            rec = self.kv.get_json(key)
            if not isinstance(rec, dict):
                continue
            r = rec.get("rank")
            if r is None or int(r) not in self.members:
                continue
            at = int(rec.get("at_step", step))
            if at <= step:
                leavers.append(int(r))
                due_at.append(at)
        joiners = []
        admit = self.kv.get_json("admit/plan")
        if isinstance(admit, dict) and \
                int(admit.get("epoch", -1)) == self.epoch and \
                int(admit.get("at_step", step)) <= step:
            joiners = [int(j) for j in admit.get("joiners", ())
                       if int(j) not in self.members]
            if joiners:
                due_at.append(int(admit.get("at_step", step)))
        if not leavers and not joiners:
            return None
        return sorted(set(leavers)), joiners, max(due_at)

    # -- gang barrier ----------------------------------------------------------

    def barrier(self, name, timeout=None):
        """KV-plane barrier that stays responsive to member death: a
        dead peer raises :class:`RankFailure` instead of hanging (unlike
        a process-group barrier, which fate-shares)."""
        self.kv.put_json(f"barrier/{self.epoch}/{name}/{self.rank}",
                         {"rank": self.rank, "t": time.time()})
        deadline = time.monotonic() + (timeout or self.reshape_timeout)
        want = set(self.members)
        while True:
            present = set()
            for key, _ in self.kv.scan(f"barrier/{self.epoch}/{name}"):
                try:
                    present.add(int(key.rsplit("/", 1)[1]))
                except ValueError:
                    pass
            if want <= present:
                return
            self._check_epoch()
            dead = self.detector.poll() & want
            dead.discard(self.rank)
            if dead:
                raise RankFailure(dead, self.epoch)
            if time.monotonic() > deadline:
                raise MXNetError(
                    f"gang barrier {name!r} (epoch {self.epoch}): "
                    f"missing ranks {sorted(want - present)} after "
                    f"{timeout or self.reshape_timeout}s")
            time.sleep(0.01)

    # -- the members' process group --------------------------------------------

    def form_process_group(self):
        """Form the default process group over this epoch's members
        (``distributed.form_group``: world ``len(members)``, this rank's
        place its index in them, the rendezvous under the KV prefix of
        the epoch); a survivor calls it after each ``recover``, every
        member at the start.  Collectives time out after
        ``reshape_timeout`` seconds.  Once formed, ``recover`` leaves the
        group before its consensus.  Returns the backend."""
        from . import distributed

        self._group_formed = True
        return distributed.form_group(self.kv, self.epoch, self.members,
                                      self.rank,
                                      timeout=self.reshape_timeout)

    def collective_failure(self, exc):
        """What a collective that failed (a peer's closed socket, gloo's
        timeout, the ``Watchdog``'s expiry) means for the gang: a
        :class:`RankFailure` once the detector confirms a member dead
        within four heartbeat timeouts, for the caller to raise into
        ``recover``; ``exc`` itself when every member stays alive (a
        fault that is not a death).  A collective that straddles a death
        fails on every survivor this way: a member whose call completed
        fails its next one (the others leave the group in ``recover``),
        or its next ``step_tick``."""
        deadline = time.monotonic() + 4 * self.detector.timeout
        while True:
            self._check_epoch()
            dead = self.detector.poll() & set(self.members)
            dead.discard(self.rank)
            if dead:
                _tel_event("collective_failure", epoch=self.epoch,
                           dead=sorted(dead),
                           error=f"{type(exc).__name__}: {exc}"[:200])
                return RankFailure(dead, self.epoch)
            if time.monotonic() > deadline:
                return exc
            time.sleep(0.01)

    # -- reshape protocol ------------------------------------------------------

    def recover(self, failure=None, checkpointer=None):
        """Run the epoch-consensus reshape and assemble the restore
        state.  Returns a :class:`RecoveryInfo`; the caller re-partitions
        its trainer state from ``info.shards`` (peer source) or
        ``info.full_state`` (disk source) and resumes at
        ``info.snap_step``.  Raises :class:`GangFenced` when the KV
        becomes unreachable mid-reshape or the proposal cannot gather a
        strict majority of the previous epoch's acks."""
        if self._group_formed:
            # leave the members' process group first: a survivor still
            # waiting in a collective on this rank fails at once (its
            # socket closes) instead of at the group's timeout, and comes
            # to recover too
            from . import distributed

            distributed.leave_group()
        try:
            return self._recover_inner(failure, checkpointer)
        except _gang_kv_errors() as e:
            raise self._fenced(e) from e

    def _recover_inner(self, failure=None, checkpointer=None):
        t0 = time.monotonic()
        ck = checkpointer or self.checkpointer
        dead = set(failure.dead) if failure is not None else set()
        joiners = set(failure.joiners) if failure is not None else set()
        planned = bool(getattr(failure, "planned", False))
        target = getattr(failure, "at_step", None)
        old_members = list(self.members)
        proposal = self._await_proposal(dead, joiners, ck,
                                        target_step=target,
                                        planned=planned)
        epoch = int(proposal["epoch"])
        new_members = [int(r) for r in proposal["members"]]
        if self.rank not in new_members:
            raise GangEvicted(
                f"rank {self.rank}: reshape to epoch {epoch} excludes "
                f"this rank; exiting cleanly")
        old_members = [int(r) for r in
                       proposal.get("old_members", old_members)]
        dead = set(int(r) for r in proposal.get("dead", []))
        joined = [int(r) for r in proposal.get("joined", [])]
        self.kv.put_json(f"epoch_ack/{epoch}/{self.rank}",
                         {"rank": self.rank, "t": time.time()})
        self._await_acks(epoch, new_members, old_members, proposal)
        cur = self.kv.get_json("epoch/current") or {}
        if int(cur.get("epoch", -1)) == epoch and \
                sorted(int(r) for r in cur.get("members", [])) \
                != sorted(new_members):
            # amended in place: a proposed member died before acking
            new_members = [int(r) for r in cur["members"]]
            dead = set(int(r) for r in cur.get("dead", []))
            joined = [int(r) for r in cur.get("joined", [])]
            if self.rank not in new_members:
                raise GangEvicted(
                    f"rank {self.rank}: epoch {epoch} was amended to "
                    f"exclude this rank; exiting cleanly")
        source = proposal.get("source", "disk")
        snap_step = int(proposal["snap_step"])
        shards = None
        full_state = None
        if source == "peer":
            shards = self._assemble_shards(snap_step, old_members, dead)
            if shards is None:
                source = "disk"     # a holder vanished under us
        if source == "disk":
            if ck is None:
                raise MXNetError(
                    "elastic recovery needs the disk manifest (no RAM "
                    "coverage) but no checkpointer is attached")
            disk_step = proposal.get("disk_step")
            snap_step = int(disk_step if disk_step is not None
                            else ck.latest_step())
            full_state = ck.restore(snap_step)
            _tel_count("elastic.disk_restores")
        planned = bool(proposal.get("planned", planned))
        # adopt the new membership
        self.epoch = epoch
        self.members = new_members
        self._fenced_at = None
        self._fence_to(epoch)
        _tel_identity(rank=self.rank, world=len(self.members))
        for d in dead:
            self.detector.forget(d)
        for j in joined:
            self.detector.watch(j)
        self._last_snap_step = None
        # tell the store of the new membership, only when the kvstore
        # module is loaded (with none loaded there is nothing cached for
        # the old membership)
        _kvstore = sys.modules.get(f"{__package__}.kvstore")
        if _kvstore is not None:
            try:
                _kvstore.notify_mesh_reshape(epoch)
            except Exception:       # noqa: BLE001 — best-effort
                pass
        ms = (time.monotonic() - t0) * 1000.0
        for d in sorted(dead):
            if planned:
                _tel_event("rank_drained", rank=d, epoch=epoch)
            else:
                _tel_event("rank_dead", rank=d, epoch=epoch)
        for j in sorted(joined):
            _tel_event("rank_rejoin", rank=j, epoch=epoch)
        _tel_event("mesh_reshape", epoch=epoch, world=len(new_members),
                   members=new_members, step=snap_step, planned=planned)
        _tel_event("elastic_recover", epoch=epoch, step=snap_step,
                   source=source, recovery_ms=round(ms, 2),
                   planned=planned)
        sys.stderr.write(
            f"[resilience] rank {self.rank}: gang reshaped to epoch "
            f"{epoch} world {len(new_members)} "
            f"({'planned, ' if planned else ''}source={source}, "
            f"snap_step={snap_step}, {ms:.0f} ms)\n")
        # end-of-assembly marker: departed ranks' RAM shards may be
        # pruned once every member has written this (see snapshot())
        self.kv.put_json(f"epoch_done/{epoch}/{self.rank}",
                         {"rank": self.rank, "t": time.time()})
        return RecoveryInfo(epoch=epoch, members=new_members,
                            snap_step=snap_step, source=source,
                            dead=dead, joined=joined, recovery_ms=ms,
                            shards=shards, full_state=full_state,
                            old_members=old_members, planned=planned)

    def join(self, timeout=None):
        """A (re)spawned rank asks the running gang for admission.

        Publishes ``join_req/<rank>``, waits for the proposer to admit
        it in a new epoch, then runs the shared ``recover`` path (ack,
        fetch every old member's shard from live RAM holders — the
        joiner has none of its own).  Returns the :class:`RecoveryInfo`
        to resume from, or None when the gang is fresh (nothing to
        join)."""
        self.start()    # writes/adopts the epoch record for fresh gangs
        cur = self.kv.get_json("epoch/current")
        if cur is None or self.rank in cur.get("members", []):
            # fresh gang (or a relaunch before any reshape): start()
            # already adopted the current epoch/membership
            return None
        self.kv.put_json(f"join_req/{self.rank}",
                         {"rank": self.rank, "t": time.time()})
        deadline = time.monotonic() + (timeout or self.reshape_timeout)
        while True:
            cur = self.kv.get_json("epoch/current") or {}
            if self.rank in cur.get("members", []):
                break
            if time.monotonic() > deadline:
                raise MXNetError(
                    f"rank {self.rank}: join request not admitted "
                    f"within {timeout or self.reshape_timeout}s")
            time.sleep(0.05)
        # participate in the admitting epoch's recover flow
        self.epoch = int(cur["epoch"]) - 1
        self.members = [int(r) for r in
                        cur.get("old_members", cur["members"])]
        self.detector = FailureDetector(self.kv, self.rank, self.members,
                                        timeout=self.detector.timeout)
        self.straggler.detector = self.detector
        return self.recover(None)

    def park_fenced(self, timeout=None, poll=0.25):
        """Minority-side parking after :class:`GangFenced`: keep
        heartbeating (the publisher thread already swallows KV errors),
        do NOT step, do NOT write anything durable — just probe the KV
        until it is reachable again, then rejoin through the normal
        ``join_req`` path, adopting the majority's state instead of our
        own.  Returns `join`'s :class:`RecoveryInfo`, or None when no
        newer epoch excluded us (we are still a member — resume
        stepping as-is).  Raises :class:`GangFenced` again if the
        partition outlives ``timeout`` seconds."""
        t0 = self._fenced_at if self._fenced_at is not None \
            else time.monotonic()
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            try:
                self.kv.get_json("epoch/current")    # read-only probe
                break
            except _gang_kv_errors():
                if deadline is not None and \
                        time.monotonic() > deadline:
                    raise self._fenced(
                        f"partition did not heal within {timeout}s")
            time.sleep(poll)
        fenced_ms = (time.monotonic() - t0) * 1000.0
        self._fenced_at = None
        _tel_event("partition_healed", rank=self.rank, epoch=self.epoch,
                   fenced_ms=round(fenced_ms, 2))
        sys.stderr.write(
            f"[resilience] rank {self.rank}: partition healed after "
            f"{fenced_ms:.0f} ms fenced; rejoining\n")
        return self.join()

    # -- protocol internals ----------------------------------------------------

    def _await_proposal(self, dead, joiners, ck, target_step=None,
                        planned=False):
        """Wait for (or, as the lowest-ranked survivor, write) the next
        epoch proposal.  Proposer promotion is implicit: if the lowest
        survivor dies before proposing, the detector adds it to ``dead``
        and the next-lowest takes over.  A planned reshape carries a
        ``target_step`` the proposal must be able to restore at (every
        member snapshotted there); the target is dropped halfway to the
        reshape timeout so a wedged drain degrades to lost steps rather
        than a dead gang.

        The proposal is STAGED at ``epoch/proposed`` with a plain put —
        advancing the fence now would reject healthy same-epoch
        snapshot writes mid-reshape; only the quorum-gated commit in
        `_await_acks` writes ``epoch/current`` and moves the fence."""
        deadline = time.monotonic() + self.reshape_timeout
        t_half = time.monotonic() + self.reshape_timeout / 2
        while True:
            cur = self.kv.get_json("epoch/current")
            if cur and int(cur.get("epoch", 0)) > self.epoch:
                return cur
            prop = self.kv.get_json("epoch/proposed")
            if prop and int(prop.get("epoch", 0)) > self.epoch:
                return prop
            dead |= self.detector.poll(force=True) & set(self.members)
            dead.discard(self.rank)
            survivors = sorted(set(self.members) - dead)
            if joiners:
                joiners = set(self._pending_joiners()) | set(joiners)
            if self._is_proposer(survivors):
                want = target_step \
                    if time.monotonic() < t_half else None
                proposal = self._make_proposal(dead, joiners,
                                               survivors, ck,
                                               target_step=want,
                                               planned=planned)
                if proposal is not None:
                    self.kv.put_json("epoch/proposed", proposal)
                    return proposal
            if time.monotonic() > deadline:
                raise MXNetError(
                    f"rank {self.rank}: no epoch proposal within "
                    f"{self.reshape_timeout}s (members "
                    f"{self.members}, dead {sorted(dead)})")
            time.sleep(0.05)

    def _make_proposal(self, dead, joiners, survivors, ck,
                       target_step=None, planned=False):
        new_members = sorted(set(survivors) | set(joiners))
        # common RAM restore point: the newest step that EVERY survivor
        # still holds (each advertises its retained steps, not just the
        # latest — a rank killed mid-snapshot-round leaves the others
        # one interval ahead, and the retention window is what lets
        # them meet one step back) and that each dead rank's live buddy
        # holds that rank's shard at
        common = None
        for r in survivors:
            info = self.kv.get_json(f"snap/{r}")
            if not info or int(info.get("epoch", -1)) != self.epoch:
                common = None
                break
            steps = set(int(s) for s in
                        info.get("steps") or [info["step"]])
            common = steps if common is None else common & steps
            if not common:
                break
        if common:
            for d in dead:
                holder = self.buddy_of(d, self.members)
                held = self.kv.get_json(f"held/{holder}/{d}")
                if holder in dead or not held \
                        or int(held.get("epoch", -1)) != self.epoch:
                    common = None
                    break
                common &= set(int(s) for s in held.get("steps", []))
                if not common:
                    break
        if target_step is not None and \
                not (common and max(common) >= int(target_step)):
            # planned reshape: restore point must be the agreed drain
            # step (zero lost steps) — a straggler's snapshot hasn't
            # landed yet, so don't propose; loop and retry
            return None
        ram_step = max(common) if common else None
        source = "peer" if ram_step is not None else "disk"
        disk_step = None
        if source == "disk":
            disk_step = ck.latest_step() if ck is not None else None
            if disk_step is None:
                raise MXNetError(
                    "elastic recovery: no common RAM snapshot and no "
                    "committed disk checkpoint to fall back to")
        for j in joiners:
            self.kv.delete(f"join_req/{j}")
        for d in dead:
            self.kv.delete(f"leave/{d}")
        self.kv.delete("admit/plan")
        return {"epoch": self.epoch + 1, "members": new_members,
                "old_members": list(self.members),
                "dead": sorted(dead), "joined": sorted(joiners),
                "snap_step": ram_step if source == "peer" else disk_step,
                "disk_step": disk_step, "source": source,
                "planned": bool(planned),
                "proposer": self.rank, "t": time.time()}

    def _await_acks(self, epoch, new_members, old_members=None,
                    proposal=None):
        """The ack round, quorum gate, and fenced commit.

        Every proposed member acks ``epoch_ack/<e>/<r>`` (written by
        `recover` before this call).  The epoch is COMMITTABLE only
        once the acks cover a strict majority of the PREVIOUS epoch's
        members — dead ranks count against, not for, so the minority
        side of a partition can never commit an epoch, no matter what
        its detector believes.  The lowest live proposed member then
        commits ``epoch/current`` with a fenced compare-and-swap
        (`put_if_epoch`) — which advances the fence and retires the
        staged ``epoch/proposed`` — and everyone returns once the
        committed membership has fully acked.  A deadline without
        quorum raises :class:`GangFenced` (park, rejoin after heal); a
        deadline with quorum but missing acks keeps the legacy
        :class:`MXNetError`."""
        from . import distributed
        deadline = time.monotonic() + self.reshape_timeout
        want = set(int(r) for r in new_members)
        prev = set(int(r) for r in
                   (old_members if old_members is not None
                    else self.members))
        quorum_of = prev or want
        quorum_ok = not self._quorum
        while True:
            cur = self.kv.get_json("epoch/current") or {}
            committed = int(cur.get("epoch", -1)) == epoch
            rec = cur if committed else \
                (self.kv.get_json("epoch/proposed") or {})
            if int(rec.get("epoch", -1)) == epoch:
                # the record is the source of truth: it may have been
                # amended below while we waited
                want = set(int(r) for r in rec.get("members", want))
                if self.rank not in want:
                    raise GangEvicted(
                        f"rank {self.rank}: epoch {epoch} was amended "
                        f"to exclude this rank; exiting cleanly")
            acked = set()
            for key, _ in self.kv.scan(f"epoch_ack/{epoch}"):
                try:
                    acked.add(int(key.rsplit("/", 1)[1]))
                except ValueError:
                    pass
            if not quorum_ok:
                quorum_ok = 2 * len(acked & quorum_of) > len(quorum_of)
            if committed and want <= acked:
                return
            # a proposed member that dies BETWEEN the proposal and its
            # ack would wedge this epoch forever (nobody re-detects it
            # once everyone is in recover).  The lowest live proposed
            # member amends the SAME epoch in place, shrinking the
            # membership to the ranks that can still ack; shard
            # assembly re-reads the amended record and falls back to
            # disk if the second death cost it a RAM holder.  The
            # amendment is a fenced CAS: a zombie amender carrying a
            # stale epoch is rejected server-side instead of clobbering
            # the committed record.
            newly_dead = (want - acked) & self.detector.poll(force=True)
            newly_dead.discard(self.rank)
            live = sorted(want - newly_dead)
            amender = bool(newly_dead) and live and self.rank == min(live)
            if amender and int(rec.get("epoch", -1)) == epoch:
                rec["members"] = live
                rec["dead"] = sorted(
                    set(int(d) for d in rec.get("dead", []))
                    | newly_dead)
                rec["joined"] = [j for j in rec.get("joined", [])
                                 if int(j) not in newly_dead]
                rec["t"] = time.time()
                try:
                    self._put_json_fenced(
                        "epoch/current" if committed else
                        "epoch/proposed", rec,
                        epoch if committed else self.epoch)
                except distributed.FencedWrite:
                    pass    # the fence moved under us: re-read above
                continue
            if not committed and quorum_ok and live \
                    and self.rank == min(live) and self.rank in acked:
                # quorum reached: commit.  put_if_epoch(epoch) advances
                # the fence, so every stale writer (minority proposer,
                # resumed zombie) is rejected from here on.
                commit = dict(rec) if int(rec.get("epoch", -1)) == epoch \
                    else dict(proposal or {})
                if int(commit.get("epoch", -1)) == epoch:
                    try:
                        self._put_json_fenced("epoch/current", commit,
                                              epoch)
                        self.kv.delete("epoch/proposed")
                    except distributed.FencedWrite:
                        pass    # a newer epoch beat us; re-read above
                    continue
            if time.monotonic() > deadline:
                if not committed and self._quorum and not quorum_ok:
                    raise self._fenced(
                        f"epoch {epoch} proposal gathered only "
                        f"{sorted(acked & quorum_of)} of previous "
                        f"members {sorted(quorum_of)} — no strict "
                        f"majority, refusing to commit (split-brain "
                        f"guard; MXTPU_QUORUM=0 overrides)")
                raise MXNetError(
                    f"epoch {epoch}: missing acks from "
                    f"{sorted(want - acked)} after "
                    f"{self.reshape_timeout}s")
            time.sleep(0.02)

    def _assemble_shards(self, snap_step, old_members, dead):
        """Every old rank's shard at ``snap_step``, from RAM: own copy,
        live peers serve their own, dead ranks' come from their buddies.
        Returns None if any fetch fails (caller degrades to disk)."""
        shards = {}
        for o in old_members:
            try:
                if o == self.rank:
                    st = self.peers.own_at(snap_step)
                elif o in dead:
                    holder = self.buddy_of(o, old_members)
                    st = self.peers.fetch(holder, o, snap_step)
                else:
                    st = self.peers.fetch(o, o, snap_step)
            except Exception as e:          # noqa: BLE001
                sys.stderr.write(
                    f"[resilience] peer shard fetch for rank {o} at "
                    f"step {snap_step} failed ({e}); falling back to "
                    f"disk\n")
                return None
            if st is None:
                return None
            shards[o] = st
        return shards


# -- autoscaling policy loop ---------------------------------------------------

class ScalePolicy:
    """Chooses the gang's world size from live telemetry.

    Grow: when the input pipeline is saturated — prefetch queue depth
    (telemetry gauge ``input.queue_depth``) at/above ``queue_high`` for
    ``window`` consecutive observations while the data-wait share stays
    at/below ``stall_low`` (compute-bound: more chips raise
    throughput) — write a ``scale/req`` record.  The launcher polls it
    and spawns extra ranks, which enter through the existing
    ``join_req`` path as a *scheduled* admit (zero lost steps).

    Shrink: ``on_preemption`` turns a preemption notice into a graceful
    drain — ``gang.plan_leave`` schedules this rank's departure a
    ``drain_margin`` of steps out, every member snapshots at the agreed
    step, and the reshape happens with no detection window.  The freed
    chips are announced (:func:`announce_freed_chips`) for the serving
    tier to claim.

    Knobs (ctor arg beats env beats default): ``MXTPU_SCALE_QUEUE_HIGH``
    (2.0), ``MXTPU_SCALE_STALL_LOW`` (0.1), ``MXTPU_SCALE_WINDOW`` (5),
    ``MXTPU_SCALE_COOLDOWN`` (30 s), ``MXTPU_SCALE_MAX_WORLD``,
    ``MXTPU_SCALE_MIN_WORLD`` (1).  The loop only runs when
    ``MXTPU_SCALE_POLICY`` is set (see :meth:`enabled`).
    """

    def __init__(self, gang, *, min_world=None, max_world=None,
                 queue_high=None, stall_low=None, window=None,
                 cooldown=None):
        def _env(name, default, cast=float):
            v = os.environ.get(name)
            return default if v in (None, "") else cast(v)

        self.gang = gang
        self.min_world = int(_env("MXTPU_SCALE_MIN_WORLD", 1, int)
                             if min_world is None else min_world)
        self.max_world = (_env("MXTPU_SCALE_MAX_WORLD", None,
                               lambda v: int(v))
                          if max_world is None else max_world)
        self.queue_high = float(_env("MXTPU_SCALE_QUEUE_HIGH", 2.0)
                                if queue_high is None else queue_high)
        self.stall_low = float(_env("MXTPU_SCALE_STALL_LOW", 0.1)
                               if stall_low is None else stall_low)
        self.window = max(1, int(_env("MXTPU_SCALE_WINDOW", 5, int)
                                 if window is None else window))
        self.cooldown = float(_env("MXTPU_SCALE_COOLDOWN", 30.0)
                              if cooldown is None else cooldown)
        self._hot = 0               # consecutive saturated observations
        self._last_req = 0.0        # monotonic time of last scale/req
        self.grow_requests = 0
        self.drains = 0

    @staticmethod
    def enabled():
        """MXTPU_SCALE_POLICY gates the whole loop (off by default)."""
        return os.environ.get("MXTPU_SCALE_POLICY", "").lower() \
            in ("1", "on", "true", "auto")

    def _queue_depth(self):
        try:
            from . import telemetry
        except ImportError:
            return None
        return telemetry.REGISTRY.gauge("input.queue_depth").value

    def observe(self, step, queue_depth=None, data_share=None):
        """Feed one step's signals; returns ``"grow"`` when a scale-up
        request was just published, else None.  ``queue_depth`` defaults
        to the live ``input.queue_depth`` gauge."""
        if queue_depth is None:
            queue_depth = self._queue_depth()
        if queue_depth is None:
            return None
        saturated = queue_depth >= self.queue_high and \
            (data_share is None or data_share <= self.stall_low)
        self._hot = self._hot + 1 if saturated else 0
        if self._hot < self.window:
            return None
        now = time.monotonic()
        if now - self._last_req < self.cooldown:
            return None
        world = len(self.gang.members)
        want = world + 1
        if self.max_world is not None and want > int(self.max_world):
            return None
        req = self.gang.kv.get_json("scale/req")
        if isinstance(req, dict) and int(req.get("want_world", 0)) \
                >= want:
            return None     # an equal-or-larger request is pending
        self.gang.kv.put_json(
            "scale/req", {"want_world": want, "step": int(step),
                          "reason": "input_saturated",
                          "queue_depth": float(queue_depth),
                          "t": time.time()})
        _tel_event("scale_up", rank=self.gang.rank, step=int(step),
                   want_world=want, world=world,
                   queue_depth=float(queue_depth))
        self._last_req = now
        self._hot = 0
        self.grow_requests += 1
        return "grow"

    def on_preemption(self, step):
        """Preemption notice → graceful drain: schedule this rank's
        planned departure and announce the chips it frees.  Returns the
        agreed departure step, or None when the gang is already at
        ``min_world``."""
        if len(self.gang.members) <= self.min_world:
            return None
        at = self.gang.plan_leave(int(step) + self.gang.drain_margin)
        _tel_event("scale_down", rank=self.gang.rank, step=int(step),
                   at_step=at, world=len(self.gang.members),
                   planned=True)
        self.drains += 1
        return at


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
