"""The trial runner: score one candidate configuration on the live
trainer.

Counterpart of ``mxnet_tpu/autotune/runner.py``.  A trial applies the
candidate's environment (``space.apply_config``), runs the trainer's own
step path (a program knob misses the capture cache and re-captures
through ``gluon/captured.py``, as a production step would), and scores
the timed steps by the mean ``wall_us`` of the telemetry step records
they emit, each marked ``tuning_trial``.

A candidate that runs out of memory is infeasible, not a crash: a
``torch.cuda.OutOfMemoryError`` (or an allocator message saying so), or
the ``tune_oom`` fault site's ``SimulatedOOM`` on the host, scores +inf
and the search goes on.  The captured step leaves the card clean after
such a failure (no stream left capturing, the failed recording's pool
released), so the next candidate starts from the memory the last good
one left.
"""

from __future__ import annotations

import math
import time

from .. import resilience, telemetry
from . import space


def trial_steps():
    """Warm steps timed per trial rung (MXTPU_TUNE_STEPS, default 3)."""
    from ..base import getenv_int

    return max(1, getenv_int("MXTPU_TUNE_STEPS", 3))


class SimulatedOOM(RuntimeError):
    """The tune_oom fault site's stand-in for the card's allocator
    failing."""

    def __init__(self):
        super().__init__(
            "RESOURCE_EXHAUSTED: injected tune_oom (MXTPU_FAULT_INJECT)")


def is_resource_exhausted(exc) -> bool:
    """True when the exception is an allocator running out of memory:
    ``torch.cuda.OutOfMemoryError`` (also when a wrapper chained it as
    its cause), or a message that says so."""
    import torch

    seen = exc
    while seen is not None:
        if isinstance(seen, torch.cuda.OutOfMemoryError):
            return True
        seen = seen.__cause__
    msg = str(exc)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg \
        or "out of memory" in msg


class TrialResult:
    """Outcome of one trial: feasible-with-score or infeasible."""

    __slots__ = ("config", "fingerprint", "feasible", "score_us",
                 "mfu", "steps", "error")

    def __init__(self, config, fingerprint, feasible, score_us,
                 mfu=None, steps=0, error=None):
        self.config = config
        self.fingerprint = fingerprint
        self.feasible = feasible
        self.score_us = score_us        # mean step wall time; inf = infeasible
        self.mfu = mfu
        self.steps = steps
        self.error = error

    def __repr__(self):
        state = f"{self.score_us:.0f}us" if self.feasible else "infeasible"
        return f"TrialResult({self.fingerprint}, {state})"


def run_trial(step_fn, config, steps=None, warmup=1):
    """Apply ``config``, run ``warmup`` untimed + ``steps`` timed steps
    through ``step_fn`` (one full training step per call), and score by
    mean StepStats wall_us.  The env is restored afterwards — the
    search, not the trial, decides what sticks."""
    steps = steps or trial_steps()
    fp = space.fingerprint(config)
    prev = space.apply_config(config)
    telemetry.trial_begin(fp)
    t0 = time.perf_counter()
    ran = 0
    try:
        if resilience.consume_fault("tune_oom"):
            raise SimulatedOOM()
        for _ in range(warmup):
            step_fn()
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
            ran += 1
    except Exception as e:
        if is_resource_exhausted(e):
            telemetry.event("tune_infeasible", fingerprint=fp,
                            error=str(e)[:200])
            return TrialResult(config, fp, feasible=False,
                               score_us=math.inf, error=str(e))
        raise
    finally:
        telemetry.trial_end()
        space.restore_env(prev)
    elapsed_us = (time.perf_counter() - t0) * 1e6
    recs = [r for r in telemetry.recent_steps(include_trials=True)
            if r.get("tuning_trial")
            and r.get("config_fingerprint") == fp]
    recs = recs[-ran:] if ran else []
    if recs:
        score = sum(r["wall_us"] for r in recs) / len(recs)
        mfus = [r["mfu"] for r in recs if r.get("mfu") is not None]
        mfu = sum(mfus) / len(mfus) if mfus else None
    else:                       # telemetry off: raw wall clock
        score = elapsed_us / max(ran, 1)
        mfu = None
    telemetry.event("tune_trial", fingerprint=fp, steps=ran,
                    score_us=round(score, 1))
    return TrialResult(config, fp, feasible=True, score_us=score,
                       mfu=mfu, steps=ran)
