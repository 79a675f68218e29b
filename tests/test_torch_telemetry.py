"""The port's telemetry (``mxnet_tpu_torch/telemetry.py``) against the
JAX package's, on the same inputs.

Step records from ``Trainer.step`` and ``Trainer.train_step`` (captured
and eager) pass the reference's ``validate_record`` and carry its field
set; histograms summarise alike; the JSONL sink rotates at the same
record under ``MXTPU_TELEMETRY_MAX_MB``; the incremental tail reads every
record across a rotation, as the reference's tail does on the same
file; the MFU of a captured step is its counted FLOPs over the interval
and the table's peak.
"""

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.telemetry as jtel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.delenv("MXTPU_TELEMETRY_PATH", raising=False)
    monkeypatch.delenv("MXTPU_TELEMETRY_MAX_MB", raising=False)
    telemetry.reset()
    jtel.reset()
    yield monkeypatch
    telemetry.reset()
    jtel.reset()


def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6),
                nn.Dense(3, in_units=16))
    return net


def _records(pkg, captured_on, monkeypatch):
    """Two train_steps and one manual backward + step on the MLP."""
    monkeypatch.setenv("MXTPU_CAPTURED_STEP", captured_on)
    rng = np.random.RandomState(9)
    xs = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, 3, 8).astype(np.float32) for _ in range(3)]
    ctx = cpu() if pkg is tmx else None
    if ctx is not None:
        ctx.__enter__()
    try:
        pkg.random.seed(7)
        net = _mlp(pkg)
        net.initialize(init=pkg.init.Xavier())
        net.hybridize()
        tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in zip(xs[:2], ys[:2]):
            tr.train_step(net, loss_fn, pkg.nd.array(x), pkg.nd.array(y))
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(xs[2])), pkg.nd.array(ys[2]))
        loss.backward()
        tr.step(8)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return pkg.telemetry.recent_steps()


@pytest.mark.parametrize("captured_on", ["1", "0"])
def test_step_records_pass_the_references_schema(fresh, captured_on):
    want = _records(jmx, captured_on, fresh)
    got = _records(tmx, captured_on, fresh)
    assert [r["path"] for r in got] == [r["path"] for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for rec in got:
        jtel.validate_record(json.loads(json.dumps(rec)))
        assert rec["v"] == jtel.SCHEMA_VERSION
    # the reference's field set; the JAX package reads a compiled
    # program's peak memory on the host too, the port only on the card
    for g, w in zip(got, want):
        assert set(g) == set(w) - {"device_peak_bytes"}
        assert set(g["breakdown_us"]) == set(w["breakdown_us"])
    if captured_on == "1":
        rec = got[0]
        assert rec["path"] == "captured" and rec["flops"] > 0
        # the counted matmul FLOPs of forward and backward: 2*8*(6*16 +
        # 16*3) forward, twice that backward less the input gradient
        assert rec["flops"] == 2 * 8 * (6 * 16 + 16 * 3) * 3 - 2 * 8 * 6 * 16
        peak = telemetry.peak_flops()
        assert rec["mfu"] == round(
            rec["flops"] / (rec["interval_us"] * 1e-6) / peak, 6)


def test_histograms_summarise_like_the_reference(fresh):
    jtel.REGISTRY.reset()
    vals = [3.5, 0.25, 7.0, 1.0, 1.0]
    for v in vals:
        telemetry.observe("h.lat_us", v)
        jtel.observe("h.lat_us", v)
    telemetry.count("c.n", 3)
    jtel.count("c.n", 3)
    telemetry.gauge_set("g.depth", 4)
    jtel.gauge_set("g.depth", 4)
    keys = ("h.lat_us", "c.n", "g.depth")
    got, want = telemetry.REGISTRY.snapshot(), jtel.REGISTRY.snapshot()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["h.lat_us"] == {
        "count": 5, "total": 12.75, "min": 0.25, "max": 7.0}


def _emit_events(mod, n):
    for i in range(n):
        mod.event("tick", i=i, pad="x" * 40)


def test_sink_rotates_like_the_reference(fresh, tmp_path):
    fresh.setenv("MXTPU_TELEMETRY_MAX_MB", "0.0015")     # 1500 bytes
    counts = {}
    for name, mod in (("port", telemetry), ("jax", jtel)):
        path = tmp_path / f"{name}.jsonl"
        fresh.setenv("MXTPU_TELEMETRY_PATH", str(path))
        _emit_events(mod, 40)
        mod.reset()
        rotated = [json.loads(l) for l in open(str(path) + ".1")]
        live = [json.loads(l) for l in open(path)]
        counts[name] = (len(rotated), len(live))
        assert [r["i"] for r in rotated + live] == list(
            range(40 - len(rotated) - len(live), 40))
        assert path.stat().st_size <= 1500
    assert counts["port"][1] > 0
    # records of the same size: the same split (the run ids have one
    # length)
    assert counts["port"] == counts["jax"]


def test_tail_reads_across_a_rotation(fresh, tmp_path):
    path = tmp_path / "t.jsonl"
    fresh.setenv("MXTPU_TELEMETRY_PATH", str(path))
    fresh.setenv("MXTPU_TELEMETRY_MAX_MB", "0.002")
    seen = {"port": [], "jax": []}
    for chunk in range(4):
        _emit_events(telemetry, 12)
        seen["port"] += [r["i"] for r in telemetry.tail_records(str(path))]
        seen["jax"] += [r["i"] for r in jtel.tail_records(str(path))]
    assert seen["port"] == seen["jax"] == list(range(12)) * 4
    read = telemetry.tail_bytes_read()
    assert telemetry.tail_records(str(path)) == []
    assert telemetry.tail_bytes_read() == read       # O(new bytes)
    # a half-written last line is held back until its newline lands
    with open(path, "a") as f:
        f.write('{"type":"event","i":99')
    assert telemetry.tail_records(str(path)) == []
    with open(path, "a") as f:
        f.write("}\n")
    assert [r["i"] for r in telemetry.tail_records(str(path))] == [99]


def test_count_flops_adds_the_kernel_formula():
    a = torch.randn(4, 5)
    b = torch.randn(5, 3)

    def fn():
        telemetry.add_kernel_flops(1000)
        return a @ b

    out, flops = telemetry.count_flops(fn)
    assert torch.equal(out, a @ b)
    assert flops == 2 * 4 * 5 * 3 + 1000
    telemetry.add_kernel_flops(7)          # no count open: ignored
    assert telemetry.count_flops(lambda: None)[1] is None
