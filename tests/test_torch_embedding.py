"""Row-sparse embeddings on the captured step (``embedding/`` +
``gluon.captured`` + ``optimizer.grouped``), after
``tests/test_embedding.py:105-281`` and ``:370-410``.

The captured sparse step must be a pure performance transform: host
unique/inverse id prep, a gather of the touched rows, a segment-sum
gradient and a row update in place, one dispatch and one guard readback
a step (ids resident on the card add one read of them to the host, as in
the JAX package; a prefetcher's stashed prep avoids it), bitwise equal to the eager row-sparse oracle (``MXTPU_SPARSE_CAPTURED=0``:
the op-by-op tape over ``sparse_embedding`` and the grouped row rule),
for SGD and Adam, with and without gradient accumulation, rows no batch
touched included.  Recordings are bounded by the unique-count buckets,
and every routing of a ``sparse_grad=True`` model to the eager oracle
emits ``sparse_fallback{reason}``.  One case holds the ``bench_embedding``
model against the JAX package (weights rtol 2e-4 / atol 2e-5); the rest
hold the port against itself and import no JAX, so the file runs on the
card's host too (``pytest --noconftest``).  The mesh8 and
``EmbeddingRules`` cases wait for the multi-GPU slice.
"""

import json
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import embedding, gluon, numerics, telemetry
from mxnet_tpu_torch.embedding import prep as emb_prep
from mxnet_tpu_torch.gluon import captured, nn
from mxnet_tpu_torch.optimizer import grouped
from torch_one_thread import one_torch_thread  # noqa: F401

VOCAB, DIM, STEPS = 50, 8, 6
WEIGHT_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _make_net(hybridize, vocab=VOCAB, dim=DIM, seed=7):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(embedding.ShardedEmbedding(vocab, dim))
        net.add(nn.Dense(3))
    net.initialize(init=mx.init.Xavier())
    if hybridize:
        net.hybridize()
    return net


def _batches(steps=STEPS, n=8, t=4, vocab=VOCAB, seed=3):
    rng = np.random.RandomState(seed)
    xs = [rng.randint(0, vocab, size=(n, t)).astype(np.float32)
          for _ in range(steps)]
    ys = [rng.randint(0, 3, size=(n,)).astype(np.float32)
          for _ in range(steps)]
    return xs, ys


def _state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _state_leaves(s)]
    return [state.asnumpy()]


def _events(path, kind):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("event") == kind]


def _run(monkeypatch, captured_on, opt="sgd", opt_params=None, k=1,
         steps=STEPS, xs=None, ys=None):
    """One training run: captured is the hybridized net through the
    captured sparse step, eager the plain net behind
    MXTPU_SPARSE_CAPTURED=0."""
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1" if captured_on else "0")
    net = _make_net(hybridize=captured_on)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), opt,
                            opt_params or {"learning_rate": 0.1})
    if xs is None:
        xs, ys = _batches(steps=steps)
    captured.reset_counters()
    losses = []
    for s in range(steps):
        loss = trainer.train_step(net, loss_fn, mx.nd.array(xs[s]),
                                  mx.nd.array(ys[s]), grad_accum=k)
        losses.append(loss.asnumpy())
    weights = [p.data().asnumpy() for p in trainer._params]
    states = {i: _state_leaves(st)
              for i, st in trainer._updaters[0].states.items()}
    return (losses, weights, states, captured.dispatch_count(),
            captured.trace_count())


# -- bitwise parity with the eager row-sparse oracle ---------------------------

@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01}),
])
@pytest.mark.parametrize("k", [1, 4])
def test_captured_sparse_bitwise_equals_eager_oracle(monkeypatch, opt,
                                                     params, k):
    """Losses, every weight (table rows no batch touched included) and
    every optimizer state: bitwise equal between the captured sparse step
    and the eager oracle."""
    le, we, se, _, _ = _run(monkeypatch, False, opt, params, k)
    lc, wc, sc, disp, _ = _run(monkeypatch, True, opt, params, k)
    assert disp == STEPS
    for s, (a, b) in enumerate(zip(le, lc)):
        np.testing.assert_array_equal(a, b, err_msg=f"loss step {s}")
    for i, (a, b) in enumerate(zip(we, wc)):
        np.testing.assert_array_equal(a, b, err_msg=f"weight {i}")
    assert set(se) == set(sc)
    for i in se:
        assert len(se[i]) == len(sc[i])
        for a, b in zip(se[i], sc[i]):
            np.testing.assert_array_equal(a, b, err_msg=f"state {i}")


def test_captured_sparse_bitwise_with_clip(monkeypatch):
    """With a global-norm clip the health's norm scales the gradients: the
    eager health reads the stored rows padded to the bucket, the shape
    the captured rows have, so the two still agree bit for bit."""
    monkeypatch.setenv("MXTPU_CLIP_GLOBAL_NORM", "0.05")
    le, we, se, _, _ = _run(monkeypatch, False, "adam",
                            {"learning_rate": 0.01})
    lc, wc, sc, disp, _ = _run(monkeypatch, True, "adam",
                               {"learning_rate": 0.01})
    assert disp == STEPS
    for a, b in zip(le + we, lc + wc):
        np.testing.assert_array_equal(a, b)


def test_untouched_rows_never_move(monkeypatch):
    """Rows outside every batch's ids keep their initial bytes in both
    modes, Adam included (a zero gradient would still move them)."""
    rng = np.random.RandomState(11)
    xs = [rng.randint(0, VOCAB // 2, size=(8, 4)).astype(np.float32)
          for _ in range(STEPS)]
    ys = [rng.randint(0, 3, size=(8,)).astype(np.float32)
          for _ in range(STEPS)]
    table0 = _make_net(hybridize=False)[0].weight.data().asnumpy()
    for cap in (False, True):
        _, weights, states, _, _ = _run(monkeypatch, cap, "adam",
                                        {"learning_rate": 0.01}, 1,
                                        xs=xs, ys=ys)
        table = weights[0]
        np.testing.assert_array_equal(table[VOCAB // 2:],
                                      table0[VOCAB // 2:])
        assert not np.array_equal(table[:VOCAB // 2], table0[:VOCAB // 2])
        for st in states[0]:
            assert not st[VOCAB // 2:].any()


@pytest.mark.parametrize("ids", ["last_row", "row_zero"])
def test_padding_that_meets_a_real_row(monkeypatch, ids):
    """A fixed bucket of 8 pads with the last real id: with the batch's
    ids at row vocab-1, or all at row 0, the padded slots write that row
    with the real slot's bits, and captured equals eager."""
    monkeypatch.setenv("MXTPU_UNIQUE_BUCKET", "8")
    rng = np.random.RandomState(5)
    if ids == "last_row":
        pool = np.array([3, 17, VOCAB - 1])
    else:
        pool = np.array([0])
    xs = [rng.choice(pool, size=(8, 4)).astype(np.float32)
          for _ in range(3)]
    ys = [rng.randint(0, 3, size=(8,)).astype(np.float32) for _ in range(3)]
    blk = embedding.ShardedEmbedding(VOCAB, DIM)
    pr = emb_prep.prepare_one(mx.nd.array(xs[0]), blk)
    assert pr.bucket == 8 and pr.uniq[-1] == pool.max()
    assert (pr.uniq[pr.n_real:] == pool.max()).all()
    assert (pr.src[pr.n_real:] == pr.n_real - 1).all()
    table0 = _make_net(hybridize=False)[0].weight.data().asnumpy()
    le, we, se, _, _ = _run(monkeypatch, False, "adam",
                            {"learning_rate": 0.01}, steps=3, xs=xs, ys=ys)
    lc, wc, sc, disp, _ = _run(monkeypatch, True, "adam",
                               {"learning_rate": 0.01}, steps=3, xs=xs,
                               ys=ys)
    assert disp == 3
    for a, b in zip(le + we + se[0], lc + wc + sc[0]):
        np.testing.assert_array_equal(a, b)
    untouched = np.setdiff1d(np.arange(VOCAB), pool)
    np.testing.assert_array_equal(wc[0][untouched], table0[untouched])


# -- dispatch / readback / recording accounting --------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_one_dispatch_one_readback_per_sparse_step(monkeypatch, k):
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    monkeypatch.setenv("MXTPU_GRAD_GUARD", "1")
    net = _make_net(hybridize=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    rng = np.random.RandomState(5)
    # one id set for every batch: one bucket, no recording after the first
    ids = rng.choice(VOCAB, size=24, replace=False)
    xs = [rng.choice(ids, size=(8, 4)).astype(np.float32) for _ in range(5)]
    ys = [rng.randint(0, 3, size=(8,)).astype(np.float32) for _ in range(5)]
    trainer.train_step(net, loss_fn, mx.nd.array(xs[0]), mx.nd.array(ys[0]),
                       grad_accum=k)
    captured.reset_counters()
    grouped.reset_dispatch_count()
    numerics.reset_readback_count()
    for s in range(1, 5):
        trainer.train_step(net, loss_fn, mx.nd.array(xs[s]),
                           mx.nd.array(ys[s]), grad_accum=k)
    assert captured.dispatch_count() == 4
    assert grouped.dispatch_count() == 0
    assert numerics.readback_count() == 4      # the guard's; ids are host data
    assert captured.trace_count() == 0


def test_retrace_bounded_by_unique_buckets(monkeypatch):
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    net = _make_net(hybridize=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    rng = np.random.RandomState(9)
    xs, ys, buckets = [], [], set()
    for s in range(10):
        ids = rng.choice(VOCAB, size=5 if s % 2 == 0 else 20, replace=False)
        xs.append(rng.choice(ids, size=(8, 4)).astype(np.float32))
        ys.append(rng.randint(0, 3, size=(8,)).astype(np.float32))
        buckets.add(emb_prep.bucket_for(
            len(np.unique(xs[-1].astype(np.int64)))))
    captured.reset_counters()
    for s in range(10):
        trainer.train_step(net, loss_fn, mx.nd.array(xs[s]),
                           mx.nd.array(ys[s]))
    assert captured.dispatch_count() == 10
    assert captured.trace_count() == len(buckets)
    assert len(buckets) <= 3


def test_lookup_fields_in_the_gauges(monkeypatch):
    """The reference's per-step ``lookup_us`` and ``unique_fraction``: on
    each captured sparse step's telemetry record, as the JAX package keeps
    them (no longer in the gauges)."""
    telemetry.reset()
    _run(monkeypatch, True, "sgd", {"learning_rate": 0.1}, 1, steps=3)
    recs = telemetry.recent_steps(path="captured")
    assert len(recs) == 3
    for rec in recs:
        telemetry.validate_record(rec)
        assert rec["lookup_us"] >= 0
        assert 0 < rec["unique_fraction"] <= 1
    snap = telemetry.REGISTRY.snapshot()
    assert "lookup_us" not in snap and "unique_fraction" not in snap


# -- sparse_fallback events: never silent --------------------------------------

def _fallback_run(monkeypatch, tmp_path, opt_params, batches, bucket=None):
    path = str(tmp_path / "ev.jsonl")
    monkeypatch.setenv("MXTPU_TELEMETRY_PATH", path)
    if bucket is not None:
        monkeypatch.setenv("MXTPU_UNIQUE_BUCKET", str(bucket))
    telemetry.reset()
    net = _make_net(hybridize=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd", opt_params)
    captured.reset_counters()
    dispatched = []
    for x, y in batches:
        loss = trainer.train_step(net, loss_fn, mx.nd.array(x),
                                  mx.nd.array(y))
        assert np.isfinite(loss.asnumpy()).all()
        dispatched.append(captured.dispatch_count())
    return dispatched, _events(path, "sparse_fallback")


def test_fallback_event_when_sparse_capture_disabled(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "0")
    xs, ys = _batches(steps=2)
    disp, evs = _fallback_run(monkeypatch, tmp_path, {"learning_rate": 0.1},
                              zip(xs, ys))
    assert disp == [0, 0]
    assert len(evs) == 2
    assert all("MXTPU_SPARSE_CAPTURED=0" in e["reason"] for e in evs)


def test_fallback_event_on_non_lazy_update(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    xs, ys = _batches(steps=2)
    disp, evs = _fallback_run(
        monkeypatch, tmp_path, {"learning_rate": 0.1, "lazy_update": False},
        zip(xs, ys))
    assert disp == [0, 0]
    assert len(evs) == 2
    assert all("lazy_update=False" in e["reason"] for e in evs)


def test_fallback_event_on_bucket_overflow(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    rng = np.random.RandomState(2)
    small = rng.choice(VOCAB, size=6, replace=False)
    batches = [(rng.choice(small, (8, 4)).astype(np.float32),
                rng.randint(0, 3, (8,)).astype(np.float32)),
               (np.arange(32, dtype=np.float32).reshape(8, 4),
                rng.randint(0, 3, (8,)).astype(np.float32))]
    disp, evs = _fallback_run(monkeypatch, tmp_path, {"learning_rate": 0.1},
                              batches, bucket=8)
    assert disp == [1, 1]          # the overflow step ran eagerly
    assert len(evs) == 1
    assert "unique count exceeds MXTPU_UNIQUE_BUCKET=8" in evs[0]["reason"]


# -- the prefetcher's id prep --------------------------------------------------

def test_prefetcher_stashes_and_captured_consumes(monkeypatch):
    from mxnet_tpu_torch.gluon.data.prefetcher import DevicePrefetcher

    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    net = _make_net(hybridize=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    xs, ys = _batches(steps=4)
    batches = [(mx.nd.array(x), mx.nd.array(y)) for x, y in zip(xs, ys)]
    pf = DevicePrefetcher(batches, depth=2, sparse_tables=net)
    popped = []
    real_pop = emb_prep.pop_prep

    def pop(data):
        got = real_pop(data)
        popped.append(got is not None)
        return got

    monkeypatch.setattr(emb_prep, "pop_prep", pop)
    captured.reset_counters()
    n = 0
    for x, y in pf:
        trainer.train_step(net, loss_fn, x, y)
        n += 1
    pf.close()
    assert n == 4 and captured.dispatch_count() == 4
    assert popped == [True] * 4          # each prep popped, once
    for x, _ in batches:
        assert real_pop(x) is None


def test_pop_prep_is_one_shot():
    data = mx.nd.array(np.array([[1.0, 2.0], [3.0, 1.0]]))
    blk = embedding.ShardedEmbedding(8, 4)
    blk.initialize()
    pr = emb_prep.prepare_one(data, blk)
    assert pr is not None
    emb_prep.stash_prep(data, {id(blk.weight): pr})
    got = emb_prep.pop_prep(data)
    assert got is not None and id(blk.weight) in got
    assert emb_prep.pop_prep(data) is None


# -- against the JAX package ---------------------------------------------------

def _bench_model(pkg, vocab, dim):
    net = pkg.gluon.nn.HybridSequential(prefix="benchemb_")
    with net.name_scope():
        net.add(pkg.embedding.ShardedEmbedding(vocab, dim),
                pkg.gluon.nn.Dense(1, in_units=dim, flatten=False))
    net.initialize(init=pkg.init.Xavier())
    net.hybridize()
    return net


def test_bench_embedding_model_matches_jax(monkeypatch):
    """``bench_embedding``'s model (ShardedEmbedding + Dense(1), Adam lr
    1e-3, loss ``(out ** 2).sum()``, zipf ids) at vocab 257, dim 8, batch
    32: 3 captured steps of the JAX package against 3 captured steps of
    the port, 3 fed by ``DevicePrefetcher(sparse_tables=net)`` and 3 eager
    ones, from the same weights."""
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    jmx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.embedding  # noqa: F401

    vocab, dim, batch = 257, 8, 32
    ids = np.random.RandomState(0).zipf(1.3, size=(3, batch)) % vocab
    jnet = _bench_model(jmx, vocab, dim)
    start = [p.data().asnumpy() for p in jnet.collect_params().values()]

    def run(pkg, net, feed=None):
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-3})
        batches = feed or [pkg.nd.array(b.astype("float32")) for b in ids]
        losses = [trainer.train_step(net, lambda out: (out ** 2).sum(), x,
                                     batch_size=batch).asnumpy()
                  for x in batches]
        return losses + [p.data().asnumpy()
                         for p in net.collect_params().values()]

    monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", "1")
    want = run(jmx, jnet)
    for cap, fed in (("1", False), ("1", True), ("0", False)):
        monkeypatch.setenv("MXTPU_SPARSE_CAPTURED", cap)
        net = _bench_model(mx, vocab, dim)
        for p, v in zip(net.collect_params().values(), start):
            p.set_data(mx.nd.array(v))
        feed = DevicePrefetcher([b.astype("float32") for b in ids], depth=2,
                                sparse_tables=net) if fed else None
        got = run(mx, net, feed)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **WEIGHT_TOL)


def test_host_prep_matches_jax(monkeypatch):
    """``bucket_for`` and the unique/inverse prep agree with the JAX
    package's; the padding differs by design (a real id, not vocab)."""
    jprep = pytest.importorskip("mxnet_tpu.embedding.prep")
    from mxnet_tpu import embedding as jemb

    for fixed in ("0", "16"):
        monkeypatch.setenv("MXTPU_UNIQUE_BUCKET", fixed)
        for n in (0, 1, 2, 3, 16, 17, 1000):
            assert emb_prep.bucket_for(n) == jprep.bucket_for(n)
    monkeypatch.setenv("MXTPU_UNIQUE_BUCKET", "0")
    x = np.random.RandomState(1).randint(-3, 70, size=(6, 5)).astype(
        np.float32)
    got = emb_prep.prepare_one(mx.nd.array(x),
                               embedding.ShardedEmbedding(64, 4))
    want = jprep.prepare_one(x, jemb.ShardedEmbedding(64, 4))
    assert (got.bucket, got.n_real, got.n_ids) == \
        (want.bucket, want.n_real, want.n_ids)
    np.testing.assert_array_equal(got.uniq[:got.n_real],
                                  want.uniq[:want.n_real])
    np.testing.assert_array_equal(got.inv, want.inv)


def test_bench_tool_on_the_host():
    """``tools.bench_embedding.run`` at a tiny size on the host: the
    reference's fields, read from the port's counters; no device numbers
    where no card ran."""
    from mxnet_tpu_torch.tools import bench_embedding

    line = bench_embedding.run(257, 8, 32, 3, device="cpu")
    assert line["metric"] == "embeddings_per_sec" and line["value"] > 0
    assert line["dispatches"] == 3 and line["cache_misses"] == 0
    assert line["eager_us"] > 0 and 0 < line["unique_fraction"] <= 1
    assert line["lookup_us"] >= 0 and line["backend"] == "cpu"
    assert line["peak_mem_gib"] is None and line["nvidia_smi"] is None
    dense = bench_embedding.run(257, 8, 32, 2, device="cpu", sparse=False)
    assert dense["eager_us"] is None and dense["lookup_us"] is None
