"""The host collector and the fleet rollup.

Counterpart of ``mxnet_tpu/obs/collector.py``.  ``HostCollector``:

- a daemon thread (never the train thread) tails this host's telemetry
  JSONL with ``telemetry.tail_records``, O(new lines) a poll, across a
  sink rotation;
- every ``MXTPU_OBS_ROLLUP_SECS`` it folds the window into one bounded
  rollup (step rates, share means, MFU, recent timeline events) and
  publishes it at ``obs/rollup/<rank>`` on the gang KV;
- it answers ``profile/req``: a request naming this rank takes a
  bounded ``torch.profiler`` trace of the next N steps (a chrome trace
  in the request's directory) and emits ``profile_captured``.

``FleetView`` reads the rollups back: fleet MFU, per-rank interval skew,
straggler attribution and the merged event timeline.  Rollups are
bounded, so the control plane carries kilobytes, not logs.
"""

from __future__ import annotations

import os
import threading
import time

from .. import telemetry

#: event kinds that belong on the fleet timeline (reshape/drain/
#: straggler/serving membership) — the collector forwards the most
#: recent few of these inside its rollup
TIMELINE_EVENTS = (
    "mesh_reshape", "rank_drained", "rank_dead", "rank_rejoin",
    "elastic_recover", "straggler_suspected", "resume", "restart",
    "scale_up_proposed", "scale_down_proposed", "serving_reload",
    "serving_replica_failover", "serving_replica_spawned",
    "profile_captured",
    # integrity plane (integrity.py): corruption verdicts and the
    # quarantine/repair around them belong on the fleet timeline
    "sdc_detected", "integrity_mismatch", "rank_quarantined",
    "replay_audit", "serving_reload_rejected",
)

_TIMELINE_MAX = 16     # events carried per rollup
_WINDOW_STEPS = 64     # step records folded into the means


def rollup_secs() -> float:
    """MXTPU_OBS_ROLLUP_SECS: collector publish period (default 2s)."""
    raw = os.environ.get("MXTPU_OBS_ROLLUP_SECS")
    try:
        v = float(raw) if raw else 2.0
    except ValueError:
        v = 2.0
    return max(0.05, v)


def request_profile(kv, rank, steps=5, logdir=None):
    """Ask the collector on `rank` for a bounded profile capture:
    write the ``profile/req`` key every collector polls.  Returns the
    request id (the ``profile/done/<rank>`` ack echoes it)."""
    req_id = f"{int(time.time() * 1e3):x}-{rank}"
    kv.put_json("profile/req", {
        "id": req_id, "rank": int(rank), "steps": int(steps),
        "logdir": logdir, "t": time.time()})
    return req_id


class HostCollector:
    """Tail this host's telemetry JSONL, publish bounded rollups, and
    answer on-demand profile requests.

    ``path``: the JSONL to tail (default MXTPU_TELEMETRY_PATH).
    ``kv``: gang KV (default `distributed.gang_kv()`); None degrades
    to local-only collection (rollup() still works, nothing publishes).
    ``rank``/``world``: fleet identity (default `telemetry.identity()`).
    ``hlo_provider``: zero-arg callable returning the step program's
    text (or None), written next to a profile capture.
    """

    def __init__(self, path=None, kv=None, rank=None, world=None,
                 period_s=None, hlo_provider=None):
        ident = telemetry.identity()
        self.path = path or telemetry.telemetry_path()
        if kv is None:
            try:
                from .. import distributed

                kv = distributed.gang_kv()
            except Exception:
                kv = None
        self.kv = kv
        self.rank = int(rank if rank is not None
                        else ident.get("rank", 0))
        self.world = int(world if world is not None
                         else ident.get("world", 1))
        self.period_s = rollup_secs() if period_s is None \
            else max(0.05, float(period_s))
        self.hlo_provider = hlo_provider
        self.polls = 0
        self.published = 0
        self.profiles_captured = 0
        self._steps = []       # bounded window of step records
        self._events = []      # bounded window of timeline events
        self._requests = 0
        self._request_queue_us = 0.0
        self._steps_total = 0
        self._skipped_total = 0
        self._attestations = 0
        self._integrity_mismatches = 0
        self._last_profile_id = None
        self._stop = threading.Event()
        self._thread = None

    # -- collection ------------------------------------------------------------

    def _fold(self, records):
        for rec in records:
            kind = rec.get("type")
            if kind == "step":
                self._steps_total += 1
                if rec.get("skipped"):
                    self._skipped_total += 1
                self._steps.append(rec)
                del self._steps[:-_WINDOW_STEPS]
            elif kind == "event":
                if rec.get("event") in TIMELINE_EVENTS:
                    self._events.append(rec)
                    del self._events[:-_TIMELINE_MAX]
            elif kind == "request":
                self._requests += 1
                self._request_queue_us += float(rec.get("queue_us", 0.0))
            elif kind == "integrity":
                self._attestations += 1
                if not rec.get("ok", True):
                    self._integrity_mismatches += 1

    def rollup(self) -> dict:
        """The bounded per-rank summary published to the control
        plane.  Scalars + a capped event list — never raw logs."""
        steps = self._steps
        n = len(steps)

        def mean(key):
            vals = [s[key] for s in steps
                    if isinstance(s.get(key), (int, float))]
            return sum(vals) / len(vals) if vals else None

        shares = {}
        for k in ("data", "host_prep", "dispatch", "readback",
                  "collective", "other"):
            vals = [s["shares"][k] for s in steps
                    if isinstance(s.get("shares"), dict)
                    and k in s["shares"]]
            if vals:
                shares[k] = round(sum(vals) / len(vals), 4)
        out = {
            "rank": self.rank, "world": self.world, "t": time.time(),
            "run": telemetry.run_id(),
            "steps_total": self._steps_total,
            "steps_window": n,
            "skipped_total": self._skipped_total,
            "last_step": steps[-1].get("step") if n else None,
            "interval_us_mean": mean("interval_us"),
            "wall_us_mean": mean("wall_us"),
            "mfu_mean": mean("mfu"),
            "bubble_fraction_mean": mean("bubble_fraction"),
            "shares": shares,
            "requests_total": self._requests,
            "request_queue_us_mean": round(
                self._request_queue_us / self._requests, 1)
            if self._requests else None,
            "attestations": self._attestations,
            "integrity_mismatches": self._integrity_mismatches,
            "events": [self._event_brief(e) for e in self._events],
        }
        return out

    @staticmethod
    def _event_brief(e):
        brief = {"event": e.get("event"), "t": e.get("t")}
        for k in ("rank", "world", "epoch", "step", "members",
                  "planned", "mean_collective_share", "laggard_step",
                  "path", "steps", "generation", "kind", "corrupt",
                  "reason"):
            if e.get(k) is not None:
                brief[k] = e[k]
        return brief

    def poll_once(self):
        """One collector tick: tail the log, answer profile requests,
        publish the rollup.  Runs on the collector thread (or directly
        from tests)."""
        self.polls += 1
        if self.path:
            self._fold(telemetry.tail_records(self.path))
        self._check_profile_request()
        if self.kv is not None:
            try:
                self.kv.put_json(f"obs/rollup/{self.rank}",
                                 self.rollup())
                self.published += 1
            except Exception:
                pass           # observability must never kill training
        return self.published

    # -- on-demand profiling ---------------------------------------------------

    def _check_profile_request(self):
        if self.kv is None:
            return
        try:
            req = self.kv.get_json("profile/req")
        except Exception:
            return
        if not isinstance(req, dict) or req.get("rank") != self.rank:
            return
        req_id = req.get("id")
        if req_id is not None and req_id == self._last_profile_id:
            return
        self._last_profile_id = req_id
        try:
            self._capture_profile(req)
        finally:
            try:
                self.kv.delete("profile/req")
            except Exception:
                pass

    def _capture_profile(self, req):
        """Bounded ``torch.profiler`` capture: trace until N more steps
        land in the tailed log (or the time budget runs out), then write
        the chrome trace, and the program text when a provider gives one,
        into the request's directory.  Runs on the collector thread: the
        train thread never blocks.  The profiler sees the CPU and, where
        there is one, the card."""
        steps = max(1, int(req.get("steps", 5)))
        logdir = req.get("logdir") or os.path.join(
            os.environ.get("MXTPU_PROFILE_DIR", "mxtpu_profile"),
            f"rank{self.rank}-{int(time.time())}")
        os.makedirs(logdir, exist_ok=True)
        budget_s = float(os.environ.get("MXTPU_PROFILE_BUDGET_S", 30.0))
        start_total = self._steps_total
        prof = None
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception:
            prof = None
        t0 = time.time()
        try:
            while (self._steps_total - start_total < steps
                   and time.time() - t0 < budget_s
                   and not self._stop.is_set()):
                time.sleep(0.02)
                if self.path:
                    self._fold(telemetry.tail_records(self.path))
        finally:
            traced = False
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    prof.export_chrome_trace(
                        os.path.join(logdir, "trace.json"))
                    traced = True
                except Exception:
                    traced = False
        hlo = None
        if self.hlo_provider is not None:
            try:
                hlo = self.hlo_provider()
            except Exception:
                hlo = None
        if hlo:
            with open(os.path.join(logdir, "step_hlo.txt"), "w",
                      encoding="utf-8") as f:
                f.write(hlo)
        self.profiles_captured += 1
        captured = self._steps_total - start_total
        telemetry.event("profile_captured", rank=self.rank,
                        steps=captured, path=logdir,
                        traced=traced, hlo=bool(hlo))
        if self.kv is not None:
            try:
                self.kv.put_json(f"profile/done/{self.rank}", {
                    "id": req.get("id"), "rank": self.rank,
                    "steps": captured, "path": logdir,
                    "t": time.time()})
            except Exception:
                pass

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtpu-obs-collector",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:    # noqa: BLE001 — keep collecting
                pass
            self._stop.wait(self.period_s)

    def close(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


class FleetView:
    """Aggregate the per-rank rollups into one fleet picture."""

    def __init__(self, kv):
        self.kv = kv
        self.rollups = {}

    def refresh(self):
        """Re-scan ``obs/rollup/*`` → {rank: rollup}."""
        import json as _json

        out = {}
        for key, raw in self.kv.scan("obs/rollup"):
            try:
                rec = _json.loads(raw.decode("utf-8")
                                  if isinstance(raw, bytes) else raw)
            except (ValueError, AttributeError):
                continue
            if isinstance(rec, dict) and rec.get("rank") is not None:
                out[int(rec["rank"])] = rec
        self.rollups = out
        return out

    def summary(self) -> dict:
        """Fleet MFU (step-weighted), interval skew, straggler
        attribution, and the merged event timeline."""
        rollups = self.rollups
        ranks = sorted(rollups)
        intervals = {r: rollups[r].get("interval_us_mean")
                     for r in ranks
                     if rollups[r].get("interval_us_mean")}
        mfu_num = mfu_den = 0.0
        for r in ranks:
            mfu = rollups[r].get("mfu_mean")
            w = rollups[r].get("steps_window") or 0
            if mfu is not None and w:
                mfu_num += mfu * w
                mfu_den += w
        skew = None
        slowest = None
        if intervals:
            slowest = max(intervals, key=intervals.get)
            lo = min(intervals.values())
            if lo > 0:
                skew = max(intervals.values()) / lo
        timeline = []
        for r in ranks:
            for e in rollups[r].get("events", []):
                timeline.append(dict(e, observed_by=r))
        timeline.sort(key=lambda e: e.get("t") or 0.0)
        return {
            "ranks": ranks,
            "world": max((rollups[r].get("world") or 0
                          for r in ranks), default=0),
            "steps_total": sum(rollups[r].get("steps_total") or 0
                               for r in ranks),
            "fleet_mfu": round(mfu_num / mfu_den, 6) if mfu_den else None,
            "interval_us": {r: round(v, 1)
                            for r, v in intervals.items()},
            "interval_skew": round(skew, 3) if skew else None,
            "slowest_rank": slowest,
            "stragglers": self._stragglers(),
            "attestations": sum(rollups[r].get("attestations") or 0
                                for r in ranks),
            "integrity_mismatches": sum(
                rollups[r].get("integrity_mismatches") or 0
                for r in ranks),
            "timeline": timeline,
        }

    def _stragglers(self):
        """Correlate StragglerMonitor suspicions with the NAMED rank's
        own interval breakdown: the suspicion says "rank R holds the
        collective up"; R's rollup says where R's time actually goes
        and how much slower than the fleet median it runs."""
        rollups = self.rollups
        med = self._median([v.get("interval_us_mean") for v in
                            rollups.values()
                            if v.get("interval_us_mean")])
        out = []
        seen = set()
        for r in sorted(rollups):
            for e in rollups[r].get("events", []):
                if e.get("event") != "straggler_suspected":
                    continue
                named = e.get("rank")
                if named is None or named in seen:
                    continue
                seen.add(named)
                entry = {"rank": named, "suspected_by": r,
                         "mean_collective_share":
                             e.get("mean_collective_share")}
                target = rollups.get(named)
                if target:
                    shares = target.get("shares") or {}
                    if shares:
                        bucket = max(shares, key=shares.get)
                        entry["stall_bucket"] = bucket
                        entry["stall_share"] = shares[bucket]
                    iv = target.get("interval_us_mean")
                    if iv and med:
                        entry["slowdown_vs_median"] = round(iv / med, 3)
                out.append(entry)
        return out

    @staticmethod
    def _median(vals):
        vals = sorted(v for v in vals if v is not None)
        if not vals:
            return None
        n = len(vals)
        return vals[n // 2] if n % 2 else \
            (vals[n // 2 - 1] + vals[n // 2]) / 2.0
