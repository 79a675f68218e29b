"""The port's serving tier on the CPU: the ServingEngine against the JAX
engine on the same weights and prompts, coalesced against one-by-one,
against the port's own generate(), its programs and counters, hot
reload, the bf16 path; the ContinuousBatcher against the reference's
cases (stub engines where the reference uses them); the env knobs, the
request records and their spans."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, serving as jserving, telemetry as jtelemetry
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu_torch import convert, serving, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serving import ServingEngine


def _jax_model(seed=7, max_length=16):
    mx.random.seed(seed)
    net = jgpt.gpt_tiny(scan_layers=True, max_length=max_length)
    net.initialize(init=mx.init.Xavier())
    net(nd.array(np.zeros((1, 4), np.float32)))
    return net


def _port_model(net, max_length=16, impl="dense", scan=False):
    """The port's gpt_tiny (the per-layer trunk unless ``scan``) with the
    JAX net's serving checkpoint loaded."""
    model = tgpt.gpt_tiny(max_length=max_length, attention_impl=impl,
                          scan_layers=scan, device=cpu())
    convert.load_state(model, jserving.state_for_serving(net))
    return model


def _prompts(n, rng, lo=2, hi=8):
    return [rng.randint(0, 128, rng.randint(lo, hi + 1)).tolist()
            for _ in range(n)]


def test_serving_exports_the_references_names():
    """The reference's serving names, less the replicas (production
    planes, not ported yet)."""
    want = set(jserving.__all__) - {"ReplicaServer", "FrontDoor",
                                    "FleetWatcher"}
    assert set(serving.__all__) == want
    for name in want:
        assert callable(getattr(serving, name)), name
    for method in ("warmup", "program_count", "reload_from_model",
                   "reload_from_state", "serve_group", "init_cache"):
        assert callable(getattr(ServingEngine, method)), method


def test_serve_group_matches_jax_engine():
    net = _jax_model()
    prompts = _prompts(3, np.random.RandomState(3))
    want, _ = jserving.ServingEngine(net, batch_buckets=(4,)) \
        .serve_group(prompts, 5)
    got, timings = ServingEngine(_port_model(net), batch_buckets=(4,)) \
        .serve_group(prompts, 5)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert timings["bucket"] == [4, 8]
    assert 0 <= timings["padded_fraction"] < 1


def test_coalesced_equals_one_by_one():
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(1, 2, 4))
    rng = np.random.RandomState(4)
    prompts = _prompts(3, rng, lo=2, hi=11)      # buckets 8 and 16 mixed
    grouped, _ = eng.serve_group(prompts, [3, 5, 4])
    for i, p in enumerate(prompts):
        solo = eng.serve_group([p], [3, 5, 4][i])[0][0]
        np.testing.assert_array_equal(grouped[i], solo,
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_engine_matches_generate(impl, scan):
    """The cached engine and the full-recompute generate() reach the
    same greedy tokens, on either trunk layout (the engine takes the
    per-layer trunk's weights through extract_decoder_stacks);
    generate() may run the flash trunk."""
    model = _port_model(_jax_model(max_length=32), max_length=32, impl=impl,
                        scan=scan)
    prompts = _prompts(2, np.random.RandomState(5), lo=6, hi=6)
    got, _ = ServingEngine(model, batch_buckets=(2,)).serve_group(prompts, 6)
    ref = tgpt.generate(model, np.asarray(prompts), max_new_tokens=6)
    np.testing.assert_array_equal(np.stack(got), ref.asnumpy()[:, 6:])


def test_reload_from_state_swaps_weights():
    a, b = _jax_model(seed=7), _jax_model(seed=8)
    prompts = _prompts(2, np.random.RandomState(6))
    eng = ServingEngine(_port_model(a), batch_buckets=(2,))
    eng.reload_from_state(jserving.state_for_serving(b))
    assert eng.generation == 1
    got, _ = eng.serve_group(prompts, 4)
    want, _ = ServingEngine(_port_model(b), batch_buckets=(2,)) \
        .serve_group(prompts, 4)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    wider = jserving.state_for_serving(_jax_model(max_length=32))
    with pytest.raises(MXNetError, match="weight mismatch"):
        eng.reload_from_state(wider)
    assert eng.generation == 1


def test_bf16_serving_runs():
    """dtype=bfloat16: matrices, embedding tables and cache in bf16,
    reductions in f32; tokens are valid and coalescing still holds."""
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(4,),
                        dtype=torch.bfloat16)
    ck, _ = eng.init_cache(4)
    assert ck.dtype == torch.bfloat16
    prompts = _prompts(3, np.random.RandomState(7))
    grouped, _ = eng.serve_group(prompts, 4)
    for i, p in enumerate(prompts):
        assert grouped[i].shape == (4,)
        assert ((grouped[i] >= 0) & (grouped[i] < 128)).all()
        np.testing.assert_array_equal(grouped[i],
                                      eng.serve_group([p], 4)[0][0])


def test_engine_samples_with_a_generator():
    """Temperature sampling draws from the given torch.Generator: the
    same seed gives the same tokens."""
    from mxnet_tpu_torch import random

    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(2,))
    prompts = _prompts(2, np.random.RandomState(8))
    a, _ = eng.serve_group(prompts, 5, temperature=0.7,
                           generator=random.generator(1))
    b, _ = eng.serve_group(prompts, 5, temperature=0.7,
                           generator=random.generator(1))
    for x, y in zip(a, b):
        assert x.shape == (5,)
        np.testing.assert_array_equal(x, y)


def test_serve_group_rejects_bad_requests():
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(2,))
    with pytest.raises(MXNetError, match="exceeds the largest bucket"):
        eng.serve_group([[1], [2], [3]], 2)
    with pytest.raises(MXNetError, match="cache window"):
        eng.serve_group([[1] * 12], 8)
    with pytest.raises(MXNetError, match="empty prompt"):
        eng.serve_group([[]], 2)
    with pytest.raises(MXNetError, match="positive"):
        eng.serve_group([[1]], 0)


def test_prefill_logits_match_jax_engine():
    """A program's logits at each row's last prompt position against the
    JAX engine's prefill program on the same padded batch, rtol 2e-4 /
    atol 1e-5 (the reference's decode-equivalence tolerance)."""
    net = _jax_model()
    prompts = _prompts(2, np.random.RandomState(12), lo=3, hi=8)
    toks = np.zeros((2, 8), np.int32)
    lens = np.array([len(p) for p in prompts])
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    jeng = jserving.ServingEngine(net, batch_buckets=(2,))
    _, _, jlg = jeng._call(2, 8, *jeng.init_cache(2), np.zeros(2, np.int32),
                           toks)
    want = np.asarray(jlg)[np.arange(2), lens - 1]
    eng = ServingEngine(_port_model(net), batch_buckets=(2,)).warmup()
    with torch.no_grad():
        got = eng._call(2, 8, torch.zeros(2, dtype=torch.int64),
                        torch.as_tensor(toks).long(),
                        torch.as_tensor(lens - 1))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_zero_retraces_after_warmup_across_all_buckets():
    """warmup() builds |batch buckets| x (|prefill buckets| + 1) programs
    and emits serving_warmup; the request path then runs no step body
    outside a program, across every bucket (tests/test_serving.py's
    pin)."""
    telemetry.reset()
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(1, 2, 4))
    c0 = serving.compile_count()
    eng.warmup()
    # (prefill buckets 8, 16 for W=16) + decode, per batch bucket
    assert eng.program_count() == 3 * 3
    assert serving.compile_count() == c0 + 9
    assert telemetry.event_counts().get("serving_warmup") == 1
    pinned = serving.trace_count()
    d0 = serving.dispatch_count()
    rng = np.random.RandomState(11)
    for n in (1, 2, 3, 4):
        eng.serve_group(_prompts(n, rng), 4)
    eng.serve_group(_prompts(2, rng, lo=9, hi=12), 3)    # 16-bucket
    assert serving.trace_count() == pinned, \
        "request path ran the step outside a program after warmup"
    assert serving.compile_count() == c0 + 9
    assert serving.dispatch_count() == d0 + 4 * 4 + 3
    serving.reset_counters()
    assert (serving.trace_count(), serving.compile_count(),
            serving.dispatch_count()) == (0, 0, 0)


def test_reload_from_model_swaps_weights_like_jax():
    """reload_from_model: generation counts, a serving_reload event, and
    the next group serves the new model's tokens, the JAX engine's after
    the same reload; an incompatible model is refused and changes
    nothing."""
    telemetry.reset()
    a, b = _jax_model(seed=7), _jax_model(seed=8)
    prompts = _prompts(2, np.random.RandomState(13))
    eng = ServingEngine(_port_model(a), batch_buckets=(2,)).warmup()
    eng.reload_from_model(_port_model(b), step=5)
    assert eng.generation == 1
    assert telemetry.event_counts().get("serving_reload") == 1
    rec = [r for r in telemetry._RECENT if r.get("event") ==
           "serving_reload"][0]
    assert rec["generation"] == 1 and rec["step"] == 5
    got, tm = eng.serve_group(prompts, 4)
    assert tm["generation"] == 1
    jeng = jserving.ServingEngine(a, batch_buckets=(2,))
    jeng.reload_from_model(b)
    want, _ = jeng.serve_group(prompts, 4)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    relu = tgpt.gpt_tiny(max_length=16, device=cpu())
    relu.encoder.layers[0]._activation = "relu"
    with pytest.raises(MXNetError, match="incompatible model"):
        eng.reload_from_model(relu)
    with pytest.raises(MXNetError, match="integrity plane"):
        eng.reload_from_state(serving.state_for_serving(_port_model(a)),
                              expect_fp=1)
    assert eng.generation == 1


def test_bench_serving_tool_on_the_host(monkeypatch):
    """tools.bench_serving.run's path and line on the CPU, with gpt_tiny
    in gpt2_small's place: warm-up builds 4 x (|prefill buckets| + 1)
    programs, the requests (one by one, then through the batcher) run no
    step outside one and record none, each of the 24 gets its 8 tokens,
    and the line carries the reference's fields (bench.py's
    bench_serving)."""
    from mxnet_tpu_torch.tools import bench_serving

    monkeypatch.setattr(bench_serving.gpt, "gpt2_small", tgpt.gpt_tiny)
    res = bench_serving.run(cpu())
    n_prefill = len(serving.prefill_buckets_for(64))    # gpt_tiny's window
    assert res["programs"] == 4 * (n_prefill + 1) == 20
    assert res["retraces_after_warmup"] == 0
    assert res["recordings_after_warmup"] == 0
    assert (res["requests"], res["new_tokens"], res["clients"],
            res["batch"]) == (24, 8, 8, 8)
    assert 1 <= res["groups_served"] <= 24
    assert res["model"] == "gpt_tiny" and res["dtype"] == "float32"
    assert res["nvidia_smi"] is None and res["peak_mem_after_warmup_gib"] \
        is None
    for key in ("value", "p99_us", "tokens_per_sec",
                "tokens_per_sec_unbatched", "batched_ratio",
                "unbatched_p50_us"):
        assert np.isfinite(res[key]) and res[key] > 0, key
    assert 0.0 <= res["mean_padded_fraction"] < 1.0
    assert res["metric"] == "serving_p50_us" and res["unit"] == "us/request"


# -- the continuous batcher ----------------------------------------------------

def test_batcher_coalesces_and_emits_request_records():
    telemetry.reset()
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(4,))
    eng.warmup()
    batcher = serving.ContinuousBatcher(eng, max_delay_ms=150, max_batch=4)
    try:
        prompts = _prompts(4, np.random.RandomState(2))
        futs = [batcher.submit(p, 3) for p in prompts]
        recs = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert batcher.requests_served == 4
    # all 4 queued within the 150 ms deadline: one coalesced group
    assert batcher.groups_served == 1
    grouped, _ = eng.serve_group(prompts, 3)
    for rec, want in zip(recs, grouped):
        assert rec["queue_us"] >= 0 and rec["bucket"] == [4, 8]
        np.testing.assert_array_equal(rec["tokens"], want)
    requests = telemetry.recent_requests()
    assert len(requests) == 4
    for r in requests:
        telemetry.validate_record(r)
        jtelemetry.validate_record(r)    # the reference's schema holds too
        assert r["generation"] == 0 and r["new_tokens"] == 3


def test_batcher_propagates_engine_errors():
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(2,))
    batcher = serving.ContinuousBatcher(eng, max_delay_ms=1)
    try:
        fut = batcher.submit(list(range(30)), 10)    # exceeds W=16
        with pytest.raises(MXNetError, match="cache window"):
            fut.result(timeout=120)
    finally:
        batcher.close()


class _StubEngine:
    """Engine-shaped stub: blockable, instant, no model; isolates the
    batcher's admission and deadline behaviour (tests/test_serving.py's
    stub, with the port's ``generator=``)."""

    batch_buckets = (1, 2, 4)

    def __init__(self):
        self.block = threading.Event()
        self.block.set()

    def serve_group(self, prompts, maxes, temperature=None, generator=None):
        self.block.wait()
        now = time.time()
        outs = [[1, 2, 3] for _ in prompts]
        timings = {"prefill_us": 10.0, "decode_us_per_token": 1.0,
                   "bucket": [max(len(prompts), 1), 8],
                   "padded_fraction": 0.0, "generation": 0,
                   "t_prefill0": now, "t_decode0": now + 1e-4,
                   "decode_us": 3.0}
        return outs, timings


def test_batcher_sheds_when_queue_full():
    telemetry.reset()
    eng = _StubEngine()
    eng.block.clear()               # engine wedged: the queue can only grow
    b = serving.ContinuousBatcher(eng, max_delay_ms=0.0, max_queue=2)
    try:
        futs = [b.submit([1], 2)]
        time.sleep(0.2)             # the loop takes it into the blocked serve
        futs += [b.submit([1], 2) for _ in range(2)]   # fills the queue
        with pytest.raises(serving.ServerOverloaded, match="queue full"):
            b.submit([1], 2)
        assert b.shed == 1
        assert telemetry.event_counts().get("queue_full", 0) == 1
        assert telemetry.REGISTRY.snapshot()["serving.queue_full"] == 1
        eng.block.set()             # back-pressure released: all served
        for f in futs:
            assert f.result(timeout=30)["tokens"] == [1, 2, 3]
    finally:
        eng.block.set()
        b.close(timeout=30)
    assert b.shed == 1              # the shed request never cost a slot


def test_batcher_deadline_exceeded_before_dispatch():
    telemetry.reset()
    eng = _StubEngine()
    eng.block.clear()
    b = serving.ContinuousBatcher(eng, max_delay_ms=0.0, max_queue=16)
    try:
        blocker = b.submit([1], 2)          # occupies the engine
        time.sleep(0.05)
        doomed = b.submit([1], 2, deadline_ms=10.0)
        ok = b.submit([1], 2)               # no deadline: must survive
        time.sleep(0.2)                     # the deadline passes queued
        eng.block.set()
        with pytest.raises(serving.DeadlineExceeded):
            doomed.result(timeout=30)
        assert ok.result(timeout=30)["tokens"] == [1, 2, 3]
        assert blocker.result(timeout=30)["tokens"] == [1, 2, 3]
        assert b.deadline_exceeded == 1
    finally:
        eng.block.set()
        b.close(timeout=30)
    expired = [r for r in telemetry.recent_requests()
               if r.get("deadline_exceeded")]
    assert len(expired) == 1 and expired[0]["new_tokens"] == 0
    telemetry.validate_record(expired[0])


def test_batcher_idle_blocks_instead_of_spinning():
    """The collector sits in one blocking queue.get while idle."""
    import queue as queue_mod

    from mxnet_tpu_torch.serving import batcher as batcher_mod

    calls = {"n": 0}

    class CountingQueue(queue_mod.Queue):
        def get(self, block=True, timeout=None):
            calls["n"] += 1
            return super().get(block, timeout)

    orig = batcher_mod.queue.Queue
    batcher_mod.queue.Queue = CountingQueue
    try:
        b = serving.ContinuousBatcher(_StubEngine(), max_delay_ms=1.0)
    finally:
        batcher_mod.queue.Queue = orig
    try:
        time.sleep(0.5)
        assert calls["n"] == 1, \
            f"idle batcher polled the queue {calls['n']} times in 0.5s"
        assert b.submit([1], 2).result(timeout=30)["tokens"] == [1, 2, 3]
    finally:
        b.close(timeout=30)


def test_batcher_close_drains_queued_requests():
    eng = _StubEngine()
    eng.block.clear()
    b = serving.ContinuousBatcher(eng, max_delay_ms=0.0, max_queue=16)
    futs = [b.submit([1], 2) for _ in range(4)]
    timer = threading.Timer(0.2, eng.block.set)
    timer.start()
    b.close(timeout=30)
    timer.join(timeout=5)
    assert not b._thread.is_alive()
    for f in futs:
        assert f.result(timeout=1)["tokens"] == [1, 2, 3]
    with pytest.raises(RuntimeError, match="closed"):
        b.submit([1], 2)


def test_batcher_samples_with_its_generator():
    """temperature + generator reach the engine: two batchers seeded alike
    serve a request the same sampled tokens."""
    from mxnet_tpu_torch import random

    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(1,))
    outs = []
    for _ in range(2):
        b = serving.ContinuousBatcher(eng, max_delay_ms=0.0,
                                      temperature=0.8,
                                      generator=random.generator(3))
        try:
            outs.append(b.submit([5, 6, 7], 6).result(timeout=60)["tokens"])
        finally:
            b.close()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_batcher_under_many_clients_loses_no_request():
    """More submitting threads than cores, a short switch interval: every
    future resolves once, the served count is the submitted count, and
    the engine's counters (one lock) add up."""
    import os
    import sys

    telemetry.reset()
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(1, 2, 4))
    eng.warmup()
    d0 = serving.dispatch_count()
    b = serving.ContinuousBatcher(eng, max_delay_ms=1.0, max_queue=512)
    n_threads = 2 * len(os.sched_getaffinity(0))
    per_thread = max(1, 240 // n_threads)    # within the 256-record ring
    results, errors = [], []
    lock = threading.Lock()

    def client(i):
        try:
            for j in range(per_thread):
                rec = b.submit([1 + i, 2 + j], 2).result(timeout=120)
                with lock:
                    results.append(len(rec["tokens"]))
        except BaseException as e:      # reported below
            with lock:
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
        b.close(timeout=30)
    assert not errors and not any(th.is_alive() for th in threads)
    assert results == [2] * (n_threads * per_thread)
    assert b.requests_served == n_threads * per_thread
    assert len(telemetry.recent_requests()) == n_threads * per_thread
    # one prefill and one decode dispatch a group
    assert serving.dispatch_count() - d0 == 2 * b.groups_served


# -- env knobs, records and spans ----------------------------------------------

def test_bucket_and_deadline_env_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_BUCKETS", "2,8,4")
    assert serving.batch_buckets_from_env() == (2, 4, 8)
    monkeypatch.setenv("MXTPU_SERVE_BUCKETS", "bogus")
    assert serving.batch_buckets_from_env() == (1, 2, 4, 8)
    assert serving.prefill_buckets_for(64) == (8, 16, 32, 64)
    assert serving.prefill_buckets_for(48) == (8, 16, 32, 48)
    monkeypatch.setenv("MXTPU_SERVE_MAX_DELAY_MS", "12.5")
    assert serving.max_delay_ms_from_env() == 12.5
    monkeypatch.delenv("MXTPU_SERVE_MAX_DELAY_MS")
    assert serving.max_delay_ms_from_env() == 5.0
    monkeypatch.setenv("MXTPU_SERVE_MAX_QUEUE", "7")
    assert serving.max_queue_from_env() == 7
    monkeypatch.setenv("MXTPU_SERVE_MAX_QUEUE", "nope")
    assert serving.max_queue_from_env() == 256
    assert serving.max_queue_from_env() == jserving.max_queue_from_env()


def test_request_record_schema_validates():
    telemetry.reset()
    telemetry.request_record(queue_us=12.0, prefill_us=340.0,
                             decode_us_per_token=55.5, bucket=(4, 16),
                             padded_fraction=0.25, new_tokens=8,
                             generation=2)
    recs = telemetry.recent_requests()
    assert len(recs) == 1
    telemetry.validate_record(recs[0])
    jtelemetry.validate_record(recs[0])
    for bad, field in ((dict(recs[0], bucket=[0, 16]), "bucket"),
                       (dict(recs[0], padded_fraction=1.5),
                        "padded_fraction")):
        for validate in (telemetry.validate_record,
                         jtelemetry.validate_record):
            with pytest.raises(ValueError, match=field):
                validate(bad)


class _FakeEngine:
    """serve_group-compatible stand-in (tests/test_obs.py's): the real
    batcher code path, no model."""

    batch_buckets = (4,)

    def serve_group(self, prompts, max_new_tokens, temperature=None,
                    generator=None):
        now = time.time()
        outs = [list(range(int(m))) for m in max_new_tokens]
        timings = {"bucket": [len(prompts), 8], "generation": 0,
                   "prefill_us": 120.0, "decode_us_per_token": 30.0,
                   "padded_fraction": 0.25, "t_prefill0": now,
                   "t_decode0": now + 1e-4,
                   "decode_us": 30.0 * max(len(o) for o in outs)}
        return outs, timings


@pytest.mark.parametrize("sink", ["ring", "jsonl"])
def test_direct_batcher_submit_roots_at_batcher(tmp_path, monkeypatch,
                                                sink):
    """A direct submit mints a trace rooted at the batcher, with the
    queue, prefill and decode spans under it (tests/test_obs.py), read
    from the in-memory ring or the JSONL sink."""
    from mxnet_tpu_torch.obs.spans import render_tree

    path = str(tmp_path / "serve.jsonl")
    if sink == "jsonl":
        monkeypatch.setenv("MXTPU_TELEMETRY_PATH", path)
    telemetry.reset()
    b = serving.ContinuousBatcher(_FakeEngine(), max_delay_ms=0.0,
                                  replica_id=3)
    try:
        b.submit("p", max_new_tokens=2).result(timeout=30)
    finally:
        b.close()
    recs = telemetry.recent_requests(jsonl=path if sink == "jsonl"
                                     else None)
    assert len(recs) == 1
    rec = json.loads(json.dumps(recs[0]))
    telemetry.validate_record(rec)
    jtelemetry.validate_record(rec)
    spans = {s["name"]: s for s in rec["spans"]}
    assert set(spans) == {"batcher", "queue", "prefill", "decode"}
    assert spans["batcher"]["parent"] is None
    for leaf in ("queue", "prefill", "decode"):
        assert spans[leaf]["parent"] == spans["batcher"]["span_id"]
    assert spans["decode"]["attrs"]["new_tokens"] == 2
    assert rec["replica_id"] == 3 == spans["batcher"]["attrs"]["replica_id"]
    lines = render_tree(rec["spans"])
    assert lines[0].startswith("batcher") and len(lines) == 4
