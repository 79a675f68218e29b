"""Continuous batcher: coalesce concurrent requests into bucketed groups.

Counterpart of ``mxnet_tpu/serving/batcher.py``, the whole file.  One
daemon thread owns the engine.  Submitters get a
``concurrent.futures.Future`` back immediately; the loop collects
requests until either the latency deadline (``MXTPU_SERVE_MAX_DELAY_MS``
past the first queued request; later arrivals do not extend it) or the
largest batch bucket is reached, serves the group through the engine's
bucketed programs (on the card, recorded CUDA graphs), and resolves every
future.

The deadline is the latency/throughput dial: 0 serves each request the
moment the engine is free (lowest latency, no coalescing); a few ms lets
concurrent clients share a prefill and decode pass.

``before_batch`` runs between groups with the engine idle: the hook a
replica uses to swap reloaded weights with no dropped request.  Sampling
at ``temperature`` draws from ``generator`` (a ``torch.Generator`` on the
engine's device), as ``ServingEngine.serve_group`` does.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future

from .. import telemetry
from ..base import MXNetError, getenv_int
from ..obs.spans import Trace


class ServerOverloaded(MXNetError):
    """submit() on a full admission queue: the request is shed
    immediately instead of growing tail latency unboundedly."""


class DeadlineExceeded(MXNetError):
    """The request's deadline passed before it reached the engine."""


def max_delay_ms_from_env(default=5.0):
    raw = os.environ.get("MXTPU_SERVE_MAX_DELAY_MS")
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        return default


def max_queue_from_env(default=256):
    return max(1, getenv_int("MXTPU_SERVE_MAX_QUEUE", default))


_SHUTDOWN = object()    # close() sentinel: wakes the blocked collector


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "future", "t_enqueue",
                 "deadline", "trace", "span", "qspan")

    def __init__(self, prompt, max_new_tokens, deadline_ms=None,
                 trace=None, replica_id=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = (None if deadline_ms is None
                         else self.t_enqueue + float(deadline_ms) / 1e3)
        # span tree (obs/spans.py): a trace minted upstream arrives with
        # an open root; a direct submit roots at the batcher
        t_wall = time.time()
        if trace is None:
            trace = Trace()
            self.span = trace.begin("batcher", t0=t_wall,
                                    replica_id=replica_id)
        else:
            self.span = trace.begin("batcher", parent=trace.root(),
                                    t0=t_wall, replica_id=replica_id)
        self.trace = trace
        self.qspan = trace.begin("queue", parent=self.span, t0=t_wall)


class ContinuousBatcher:
    """Queue + serving loop over a ServingEngine.

    ``submit(prompt, max_new_tokens)`` → Future resolving to a dict:
    ``tokens`` (np.int32 generated ids) plus the per-request record
    fields (queue_us, prefill_us, decode_us_per_token, bucket,
    padded_fraction, generation).
    """

    def __init__(self, engine, max_delay_ms=None, max_batch=None,
                 before_batch=None, temperature=None, generator=None,
                 max_queue=None, replica_id=None):
        self.engine = engine
        self.replica_id = replica_id
        self.max_delay_ms = (max_delay_ms_from_env()
                             if max_delay_ms is None else max_delay_ms)
        self.max_batch = max_batch or max(engine.batch_buckets)
        self.max_queue = (max_queue_from_env()
                          if max_queue is None else max(1, int(max_queue)))
        self.before_batch = before_batch
        self._temperature = temperature
        self._generator = generator
        self._q = queue.Queue(maxsize=self.max_queue)
        self._stop = threading.Event()
        self.groups_served = 0
        self.requests_served = 0
        self.shed = 0
        self.deadline_exceeded = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtpu-batcher", daemon=True)
        self._thread.start()

    def submit(self, prompt, max_new_tokens=16, deadline_ms=None,
               trace=None):
        """Enqueue one request → Future.  Raises
        :class:`ServerOverloaded` when the admission queue is full (the
        caller decides whether to retry elsewhere);
        a ``deadline_ms`` budget resolves the future with
        :class:`DeadlineExceeded` if group formation can't reach it in
        time.  ``trace``: an obs.spans.Trace minted upstream (a front
        door): batcher/prefill/decode spans attach under its root; None
        mints a batcher-rooted trace."""
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        req = _Request(prompt, max_new_tokens, deadline_ms,
                       trace=trace, replica_id=self.replica_id)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.shed += 1
            telemetry.count("serving.queue_full")
            telemetry.event("queue_full", depth=self.max_queue)
            raise ServerOverloaded(
                f"serving queue full ({self.max_queue} pending); "
                f"request shed") from None
        return req.future

    def _collect(self):
        """Block for the first request, then coalesce until the deadline
        or the largest bucket fills.  Blocking (not polling): an idle
        replica costs zero CPU; close() wakes the block with a
        sentinel — _collect returns None and the loop exits to drain."""
        first = self._q.get()
        if first is _SHUTDOWN:
            return None
        group = [first]
        deadline = first.t_enqueue + self.max_delay_ms / 1e3
        while len(group) < self.max_batch:
            wait = deadline - time.perf_counter()
            if wait <= 0:
                # deadline hit — grab whatever is already queued, no wait
                try:
                    while len(group) < self.max_batch:
                        item = self._q.get_nowait()
                        if item is _SHUTDOWN:
                            break       # _loop re-checks _stop next
                        group.append(item)
                except queue.Empty:
                    pass
                break
            try:
                item = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                break
            group.append(item)
        return group

    def _expire(self, group, now):
        """Resolve requests whose deadline passed during queueing with
        DeadlineExceeded BEFORE they cost a dispatch slot; returns the
        still-live remainder."""
        live = []
        for r in group:
            if r.deadline is None or now <= r.deadline:
                live.append(r)
                continue
            self.deadline_exceeded += 1
            telemetry.count("serving.deadline_exceeded")
            queue_us = (now - r.t_enqueue) * 1e6
            r.qspan.close(dur_us=queue_us)
            r.span.attrs["deadline_exceeded"] = True
            r.trace.close_open()
            telemetry.request_record(
                queue_us=queue_us,
                prefill_us=0.0, decode_us_per_token=0.0,
                bucket=[1, 1], padded_fraction=0.0, new_tokens=0,
                deadline_exceeded=True, replica_id=self.replica_id,
                **r.trace.to_fields())
            if not r.future.cancelled():
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed after "
                    f"{(now - r.t_enqueue) * 1e3:.1f} ms in queue"))
        return live

    def _serve(self, group):
        t_batch = time.perf_counter()
        group = self._expire(group, t_batch)
        if not group:
            return
        try:
            if self.before_batch is not None:
                self.before_batch()
            outs, timings = self.engine.serve_group(
                [r.prompt for r in group],
                [r.max_new_tokens for r in group],
                temperature=self._temperature, generator=self._generator)
        except BaseException as exc:  # resolve ALL futures, never hang
            for r in group:
                if not r.future.cancelled():
                    r.future.set_exception(exc)
            return
        self.groups_served += 1
        self.requests_served += len(group)
        t_done = time.time()
        for r, toks in zip(group, outs):
            queue_us = (t_batch - r.t_enqueue) * 1e6
            rec = dict(timings)
            rec["queue_us"] = queue_us
            rec["tokens"] = toks
            # close the request's span tree from the group's stage
            # clocks: the engine already took these readings
            r.qspan.close(dur_us=queue_us)
            r.trace.begin("prefill", parent=r.span,
                          t0=timings.get("t_prefill0"),
                          bucket=f"{timings['bucket'][0]}x"
                                 f"{timings['bucket'][1]}",
                          generation=timings["generation"]) \
                .close(dur_us=timings["prefill_us"])
            r.trace.begin("decode", parent=r.span,
                          t0=timings.get("t_decode0"),
                          new_tokens=len(toks)) \
                .close(dur_us=timings.get(
                    "decode_us",
                    timings["decode_us_per_token"] * len(toks)))
            r.trace.close_open(t_end=t_done)
            telemetry.request_record(
                queue_us=queue_us,
                prefill_us=timings["prefill_us"],
                decode_us_per_token=timings["decode_us_per_token"],
                bucket=timings["bucket"],
                padded_fraction=timings["padded_fraction"],
                new_tokens=len(toks),
                generation=timings["generation"],
                deadline_exceeded=False, replica_id=self.replica_id,
                **r.trace.to_fields())
            if not r.future.cancelled():
                r.future.set_result(rec)

    def _loop(self):
        while not self._stop.is_set():
            group = self._collect()
            if group is None:
                break
            if group:
                self._serve(group)
        # drain: resolve what is left rather than abandoning futures
        while True:
            try:
                group = [self._q.get_nowait()]
            except queue.Empty:
                break
            if group[0] is not _SHUTDOWN:
                self._serve(group)

    def close(self, timeout=30.0):
        """Stop the loop; queued requests are still served (drained)."""
        self._stop.set()
        # wake the blocked collector; the loop is consuming, so a full
        # queue clears within the timeout
        deadline = time.perf_counter() + timeout
        while self._thread.is_alive():
            try:
                self._q.put(_SHUTDOWN, timeout=0.1)
                break
            except queue.Full:
                if time.perf_counter() > deadline:
                    break
        self._thread.join(timeout)
