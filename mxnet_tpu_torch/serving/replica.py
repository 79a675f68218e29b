"""Serving replicas with hot model reload, and the front door over them.

Counterpart of ``mxnet_tpu/serving/replica.py``.  ``ReplicaServer`` is one
engine, one ``ContinuousBatcher`` and a checkpoint poller: the poller
watches an ``AsyncCheckpointer`` directory for a newer committed
``MANIFEST.json`` (``checkpoint.latest_manifest_step``), verifies it
(every shard's CRC, the integrity ledger's provenance, the gang epoch)
and restores it off the serving thread, then stages it; the batcher's
``before_batch`` hook applies the staged swap between groups, with the
engine idle.  The swap copies the new weights into the engine's static
weight tensors (no new recording), and an in-flight request runs on the
old generation or the new one, never on half of each.  With
``expect_fp=`` set (a callable of the step, or a fixed u64) the state's
integrity fingerprint must match, or the reload is refused and serving
goes on with the old weights.

``FrontDoor`` spreads requests over the replicas round-robin; with a
gang KV each replica publishes heartbeats and a ``FailureDetector``
marks a silent one dead, and a failed submission moves to the next live
replica.  ``FleetWatcher`` turns announced free cards into replicas.
"""

from __future__ import annotations

import os
import threading
import time

from .. import telemetry
from ..base import MXNetError, getenv_int
from ..obs.spans import Trace
from .batcher import ContinuousBatcher, ServerOverloaded
from .engine import ReloadRejected


def reload_poll_ms_from_env(default=200):
    return max(1, getenv_int("MXTPU_SERVE_RELOAD_POLL_MS", default))


class ReplicaServer:
    """One serving replica: batcher + checkpoint-driven hot reload.

    ``ckpt_dir``: AsyncCheckpointer directory to poll (None disables
    reload).  ``kv``/``rank``: FileKV control plane for heartbeats (the
    FrontDoor's failure detector watches them).  ``expect_fp``: the
    attested fingerprint of each reload's state, a callable of the step
    (returning None to skip the check) or one u64; a mismatch is
    refused.
    """

    def __init__(self, engine, ckpt_dir=None, poll_ms=None, kv=None,
                 rank=0, max_delay_ms=None, max_batch=None,
                 temperature=None, generator=None, expect_fp=None):
        self.engine = engine
        self.rank = rank
        self._ckpt_dir = os.fspath(ckpt_dir) if ckpt_dir else None
        self._poll_ms = (reload_poll_ms_from_env()
                         if poll_ms is None else poll_ms)
        self.loaded_step = None
        self._fetched_step = None    # newest step the poller restored
        self._served_epoch = None    # gang_epoch of the staged manifest
        self._staged = None          # (step, state) awaiting swap
        self._staged_lock = threading.Lock()
        self._stop = threading.Event()
        self.reloads = 0
        self.batcher = ContinuousBatcher(
            engine, max_delay_ms=max_delay_ms, max_batch=max_batch,
            before_batch=self._maybe_swap, temperature=temperature,
            generator=generator, replica_id=rank)
        self._expect_fp = expect_fp
        self.rejected = 0
        self._hb = None
        if kv is not None:
            from ..resilience import HeartbeatPublisher

            self._hb = HeartbeatPublisher(kv, rank)
            self._hb.start()
        self._poller = None
        if self._ckpt_dir is not None:
            self._poller = threading.Thread(
                target=self._poll_loop, name=f"mxtpu-reload-{rank}",
                daemon=True)
            self._poller.start()

    def submit(self, prompt, max_new_tokens=16, deadline_ms=None,
               trace=None):
        return self.batcher.submit(prompt, max_new_tokens,
                                   deadline_ms=deadline_ms, trace=trace)

    # -- hot reload ------------------------------------------------------------

    def poll_once(self):
        """Check the manifest; verify, restore + stage a newer step.
        Runs on the poller thread — the expensive host restore happens
        here, never on the serving thread."""
        from .. import checkpoint

        step = checkpoint.latest_manifest_step(self._ckpt_dir)
        # _fetched_step (poller-thread-private) is the dedup, NOT
        # loaded_step: a step staged but not yet swapped by the batcher
        # must not be restored (and swapped) a second time
        if step is None or step == self._fetched_step:
            return False
        ck = checkpoint.AsyncCheckpointer(
            self._ckpt_dir, rank=0, world_size=1)
        if not self._verify_reload(ck, step):
            # a corrupt checkpoint is REJECTED, never served; the step
            # still dedups (a bad file on disk will not un-corrupt —
            # without this the poller would re-verify it every 200ms
            # forever).  A subsequent GOOD step reloads normally.
            self._fetched_step = step
            return False
        state = ck.restore(step=step)
        self._fetched_step = step
        with self._staged_lock:
            self._staged = (step, state)
        return True

    def _verify_reload(self, ck, step):
        """Integrity gate ahead of the swap: re-read the manifest with
        every shard CRC-checked, and audit its attestation-ledger stamp
        (integrity.verify_provenance) when one is present.  Emits
        ``serving_reload_rejected`` and returns False on any failure."""
        from .. import integrity
        from ..resilience import CheckpointCorrupt

        try:
            m = ck.verify(step)
        except CheckpointCorrupt as exc:
            telemetry.event("serving_reload_rejected", rank=self.rank,
                            step=int(step), reason=str(exc)[:200])
            return False
        ok, why = integrity.verify_provenance(m)
        if not ok:
            telemetry.event("serving_reload_rejected", rank=self.rank,
                            step=int(step),
                            reason=f"provenance: {why}"[:200])
            return False
        # epoch fence (schema v8): never serve a manifest from a gang
        # epoch OLDER than the one already served — a fenced trainer's
        # stale commit (partition minority, resumed zombie) must not
        # roll the serving weights backwards.  Manifests without the
        # stamp (pre-v8, or gang-less trainers) pass unchanged.
        epoch = m.get("gang_epoch")
        if epoch is not None and self._served_epoch is not None \
                and int(epoch) < self._served_epoch:
            telemetry.event("serving_reload_rejected", rank=self.rank,
                            step=int(step),
                            reason=f"stale_epoch: manifest gang_epoch "
                                   f"{int(epoch)} < served "
                                   f"{self._served_epoch}"[:200])
            return False
        if epoch is not None:
            self._served_epoch = int(epoch)
        return True

    def _poll_loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:
                telemetry.event("serving_reload_error", rank=self.rank,
                                error=f"{type(exc).__name__}: {exc}")
            self._stop.wait(self._poll_ms / 1e3)

    def _maybe_swap(self):
        """Apply a staged reload — called by the batcher BETWEEN groups,
        with the engine idle, so no request ever sees a half-swap."""
        with self._staged_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return
        step, state = staged
        fp = self._expect_fp(step) if callable(self._expect_fp) \
            else self._expect_fp
        try:
            self.engine.reload_from_state(state, step=step, expect_fp=fp)
        except ReloadRejected:
            # the engine emitted serving_reload_rejected: the old weights
            # keep serving
            self.rejected += 1
            return
        self.loaded_step = step
        self.reloads += 1

    def close(self, timeout=30.0):
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout)
        if self._hb is not None:
            self._hb.stop()
        self.batcher.close(timeout)


class FrontDoor:
    """Round-robin request router over a replica group with failover.

    With a FileKV the FailureDetector confirms dead replicas from
    heartbeat silence; without one, only local submit failures mark a
    replica out.
    """

    def __init__(self, replicas, kv=None, timeout=None):
        if not replicas:
            raise MXNetError("FrontDoor: need at least one replica")
        self.replicas = list(replicas)
        self._rr = 0
        self._lock = threading.Lock()
        self._failed = set()
        self._detector = None
        if kv is not None:
            from ..resilience import FailureDetector

            self._detector = FailureDetector(
                kv, -1, [r.rank for r in self.replicas],
                timeout=timeout)

    def alive(self):
        """Replicas not confirmed dead (detector) nor locally failed."""
        dead = set(self._failed)
        if self._detector is not None:
            dead |= set(self._detector.poll())
        return [r for r in self.replicas if r.rank not in dead]

    def submit(self, prompt, max_new_tokens=16, deadline_ms=None):
        """Submit to the next live replica; fail over on submit error.

        A :class:`ServerOverloaded` shed is NOT a replica failure — the
        replica is healthy, just full — so it is retried once on the
        next replica without marking anyone out, then re-raised for the
        client to back off."""
        live = self.alive()
        if not live:
            raise MXNetError("FrontDoor: no live replicas")
        with self._lock:
            start = self._rr
            self._rr += 1
        # the distributed trace is minted HERE — the fleet's ingress —
        # so a shed-retry onto another replica stays ONE causal tree
        # with the retry visible as a root attr (obs/spans.py)
        trace = Trace()
        root = trace.begin("frontdoor")
        last_exc = None
        shed = 0
        for i in range(len(live)):
            r = live[(start + i) % len(live)]
            try:
                fut = r.submit(prompt, max_new_tokens,
                               deadline_ms=deadline_ms, trace=trace)
                if shed:
                    root.attrs["retries"] = shed
                return fut
            except ServerOverloaded as exc:
                last_exc = exc
                shed += 1
                telemetry.event("serving_request_shed", rank=r.rank)
                if shed > 1:        # one retry on the next replica
                    break
            except Exception as exc:
                last_exc = exc
                self._failed.add(r.rank)
                telemetry.event("serving_replica_failover", rank=r.rank,
                                error=f"{type(exc).__name__}: {exc}")
        if isinstance(last_exc, ServerOverloaded):
            raise last_exc
        raise MXNetError(
            f"FrontDoor: every replica refused the request "
            f"(last: {last_exc})")

    def close(self, timeout=30.0):
        for r in self.replicas:
            r.close(timeout)


class FleetWatcher:
    """Turns freed training chips into serving capacity.

    Watches the gang KV for ``chips/freed/<rank>`` announcements
    (written by ``resilience.announce_freed_chips`` after a ScalePolicy
    drain), claims each one — delete the announcement, record
    ``chips/claimed/<rank>`` — and calls ``spawn(announcement)`` to
    bring up a replica on the freed chips.  ``spawn`` returns the
    replica object (kept in ``self.replicas``) or None to decline.

    One watcher per fleet: the claim is delete-based, so concurrent
    watchers could double-claim — run it next to the FrontDoor.
    """

    def __init__(self, kv, spawn, poll_s=0.5):
        self.kv = kv
        self.spawn = spawn
        self.poll_s = float(poll_s)
        self.replicas = []
        self.claimed = 0
        self._stop = threading.Event()
        self._thread = None

    def poll_once(self):
        """Scan + claim + spawn; returns the replicas spawned now."""
        spawned = []
        for key, _ in self.kv.scan("chips/freed"):
            rec = self.kv.get_json(key)
            if not isinstance(rec, dict) or rec.get("rank") is None:
                continue
            rank = int(rec["rank"])
            self.kv.delete(key)
            self.kv.put_json(f"chips/claimed/{rank}",
                             {"rank": rank, "t": time.time()})
            self.claimed += 1
            rep = self.spawn(rec)
            telemetry.event("serving_replica_spawned", rank=rank,
                            count=int(rec.get("count", 1)),
                            spawned=rep is not None)
            if rep is not None:
                self.replicas.append(rep)
                spawned.append(rep)
        return spawned

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtpu-fleet-watcher",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:    # noqa: BLE001 — keep watching
                telemetry.event("fleet_watcher_error",
                                error=f"{type(exc).__name__}: {exc}")
            self._stop.wait(self.poll_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def _wait_all(futures, timeout=None):
    """Resolve a list of serving futures → list of result dicts."""
    deadline = None if timeout is None else time.perf_counter() + timeout
    out = []
    for f in futures:
        left = None if deadline is None \
            else max(0.0, deadline - time.perf_counter())
        out.append(f.result(timeout=left))
    return out
