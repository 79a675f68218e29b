"""Successive-halving local search over the knob space.

Counterpart of ``mxnet_tpu/autotune/search.py``.  The pool is the base
configuration and every one-knob move to an adjacent domain value (each
domain is ordered, so adjacent means something).  A rung runs every
surviving candidate for a few timed steps, keeps the faster half and
doubles the steps, within ``MXTPU_TUNE_BUDGET`` trials a capture
signature.  The base configuration is always a candidate and wins ties,
so the winner is never slower than the defaults as measured.
"""

from __future__ import annotations

import math
import os

from .. import telemetry
from . import runner as _runner
from . import space

_MODES = ("off", "replay", "search")


def mode():
    """MXTPU_AUTOTUNE: 'off' (never touch the DB), 'replay' (apply a
    stored winner, never search — the default), or 'search' (search
    when the DB has no entry, then persist)."""
    m = os.environ.get("MXTPU_AUTOTUNE", "replay").lower() or "replay"
    if m in ("0", "false"):
        m = "off"
    if m not in _MODES:
        from ..base import MXNetError

        raise MXNetError(
            f"MXTPU_AUTOTUNE={m!r}: expected one of {_MODES}")
    return m


def budget():
    """MXTPU_TUNE_BUDGET: max trials per capture signature (default
    12)."""
    from ..base import getenv_int

    return max(1, getenv_int("MXTPU_TUNE_BUDGET", 12))


def candidates(base=None, knobs=None):
    """Base + every one-knob adjacent move (deduped, base first)."""
    base = dict(base if base is not None else space.current_config())
    knobs = knobs if knobs is not None else space.searchable_knobs()
    out = [base]
    seen = {space.fingerprint(base)}
    for knob in knobs:
        for v in knob.neighbors(base.get(knob.name, knob.default)):
            cfg = dict(base)
            cfg[knob.name] = v
            fp = space.fingerprint(cfg)
            if fp not in seen:
                seen.add(fp)
                out.append(cfg)
    return out


def successive_halving(step_fn, base=None, knobs=None,
                       total_budget=None, rung_steps=None):
    """Run the search; returns (winner TrialResult, all TrialResults).

    The returned winner is the best FEASIBLE result (ties break toward
    the base config); when every candidate is infeasible — or the
    budget is 0 trials — the base config wins at +inf so the caller
    simply keeps defaults."""
    total_budget = total_budget if total_budget is not None else budget()
    rung_steps = rung_steps or _runner.trial_steps()
    pool = candidates(base, knobs)
    base_fp = space.fingerprint(pool[0])
    telemetry.event("tune_search_start", candidates=len(pool),
                    budget=total_budget)
    all_results = []
    best = {}                     # fingerprint -> best TrialResult
    spent = 0
    steps = rung_steps
    while pool and spent < total_budget:
        scored = []
        for cfg in pool:
            if spent >= total_budget:
                break
            res = _runner.run_trial(step_fn, cfg, steps=steps)
            spent += 1
            all_results.append(res)
            scored.append(res)
            prev = best.get(res.fingerprint)
            if prev is None or res.score_us < prev.score_us:
                best[res.fingerprint] = res
        if len(scored) <= 1:
            break
        scored.sort(key=lambda r: (r.score_us,
                                   r.fingerprint != base_fp))
        keep = max(1, math.ceil(len(scored) / 2))
        pool = [r.config for r in scored[:keep] if r.feasible]
        if len(pool) <= 1:
            break
        steps *= 2
    feasible = [r for r in best.values() if r.feasible]
    if feasible:
        winner = min(feasible,
                     key=lambda r: (r.score_us, r.fingerprint != base_fp))
    else:
        winner = _runner.TrialResult(dict(pool[0]) if pool else
                                     dict(candidates(base, knobs)[0]),
                                     base_fp, feasible=False,
                                     score_us=math.inf)
    base_res = best.get(base_fp)
    if base_res is not None and base_res.feasible \
            and base_res.score_us < winner.score_us:
        winner = base_res
    return winner, all_results
