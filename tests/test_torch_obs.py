"""The port's observability plane (``mxnet_tpu_torch/obs``) against the
JAX package's, on the same records.

The host collector folds one JSONL log into the reference's rollup, the
fleet view over two ranks' rollups on a ``FileKV`` summarises alike, the
Prometheus text is the reference's for the same registry, and the
exporter answers ``/metrics`` on a free local port.
"""

import json
import urllib.request

import numpy as np
import pytest

import mxnet_tpu.distributed as jdist
import mxnet_tpu.obs.collector as jcoll
import mxnet_tpu.obs.exporter as jexp
import mxnet_tpu.telemetry as jtel
from mxnet_tpu_torch import distributed, obs, telemetry
from mxnet_tpu_torch.obs import collector, exporter


@pytest.fixture
def log(monkeypatch, tmp_path):
    """A JSONL log of step, event, request and integrity records."""
    path = tmp_path / "rank0.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY_PATH", str(path))
    telemetry.reset()
    rs = np.random.RandomState(0)
    for i in range(70):
        acc = telemetry.step_begin("captured")
        telemetry.on_scope("captured_step", 1e-4)
        telemetry.note(flops=1e9, grad_norm=float(rs.rand()))
        telemetry.step_end(acc, step=i, skipped=(i == 3))
        if i % 20 == 0:
            telemetry.event("resume", step=i)
            telemetry.event("not_on_the_timeline", step=i)
    telemetry.request_record(10.0, 20.0, 3.0, (4, 64), 0.25)
    telemetry.integrity_record(step=50, fp="ab", ok=False, corrupt=[1])
    telemetry.reset()
    monkeypatch.delenv("MXTPU_TELEMETRY_PATH")
    yield str(path)
    telemetry.reset()
    jtel.reset()


def _strip(rollup):
    return {k: v for k, v in rollup.items() if k not in ("t", "run")}


def test_collector_rollup_equals_the_reference(log):
    mine = collector.HostCollector(path=log, kv=None, rank=0, world=2)
    ref = jcoll.HostCollector(path=log, kv=None, rank=0, world=2)
    mine.poll_once()
    ref.poll_once()
    got, want = mine.rollup(), ref.rollup()
    assert _strip(got) == _strip(want)
    assert got["steps_total"] == 70 and got["skipped_total"] == 1
    assert got["steps_window"] == 64 and got["requests_total"] == 1
    assert got["integrity_mismatches"] == 1
    assert [e["event"] for e in got["events"]] == ["resume"] * 4


def test_fleet_view_over_filekv_equals_the_reference(log, tmp_path):
    import shutil

    kv = distributed.FileKV(str(tmp_path / "gang"))
    logs = [log, str(tmp_path / "rank1.jsonl")]
    shutil.copy(log, logs[1])
    for rank in (0, 1):
        c = collector.HostCollector(path=logs[rank], kv=kv, rank=rank,
                                    world=2)
        c.poll_once()
    mine = collector.FleetView(kv)
    ref = jcoll.FleetView(jdist.FileKV(str(tmp_path / "gang")))
    mine.refresh()
    ref.refresh()
    assert mine.summary() == ref.summary()
    assert mine.summary()["ranks"] == [0, 1]
    assert mine.summary()["steps_total"] == 140


def test_prometheus_text_equals_the_reference(log, tmp_path):
    for mod in (telemetry, jtel):
        mod.reset()
        mod.REGISTRY.reset()
        mod.count("collective.bytes", 4096)
        mod.gauge_set("input.queue_depth", 3)
        mod.observe("serving.latency_us", 120.5)
        mod.observe("serving.latency_us", 80.0)
    kv = distributed.FileKV(str(tmp_path / "gang"))
    collector.HostCollector(path=log, kv=kv, rank=0, world=1).poll_once()
    fleet = collector.FleetView(kv)
    fleet.refresh()
    got = exporter.render_prometheus(telemetry.REGISTRY.snapshot(),
                                     fleet.summary(),
                                     registry=telemetry.REGISTRY)
    want = jexp.render_prometheus(jtel.REGISTRY.snapshot(), fleet.summary(),
                                  registry=jtel.REGISTRY)
    assert got == want
    assert "# TYPE mxtpu_collective_bytes counter\n" \
           "mxtpu_collective_bytes 4096\n" in got


def test_exporter_answers_on_a_free_port(monkeypatch):
    monkeypatch.setenv("MXTPU_METRICS_PORT", "0")
    obs.shutdown()
    telemetry.reset()
    try:
        coll, exp = obs.ensure_from_env()
        assert coll is None and exp is not None and exp.port > 0
        assert obs.ensure_from_env() == (coll, exp)     # once a process
        telemetry.count("step.skipped", 2)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/metrics", timeout=10).read()
        assert b"mxtpu_step_skipped 2" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/x",
                                   timeout=10)
    finally:
        obs.shutdown()
        telemetry.reset()


def test_profile_request_takes_a_bounded_trace(log, tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_PROFILE_BUDGET_S", "0.3")
    kv = distributed.FileKV(str(tmp_path / "gang"))
    c = collector.HostCollector(path=log, kv=kv, rank=0, world=1)
    req = collector.request_profile(kv, 0, steps=2,
                                    logdir=str(tmp_path / "prof"))
    c.poll_once()
    done = kv.get_json("profile/done/0")
    assert done["id"] == req and c.profiles_captured == 1
    assert (tmp_path / "prof" / "trace.json").exists()
    assert json.load(open(tmp_path / "prof" / "trace.json"))
    assert kv.get_json("profile/req") is None


def test_profile_dir_defaults_to_the_temp_dir(log, tmp_path, monkeypatch):
    """A capture request without a directory writes under
    ``<tempdir>/mxtpu_profile`` (``/tmp/mxtpu_profile``, as in the JAX
    package, unless TMPDIR says otherwise), never the working directory."""
    import tempfile

    monkeypatch.delenv("MXTPU_PROFILE_DIR", raising=False)
    monkeypatch.setenv("MXTPU_PROFILE_BUDGET_S", "0.3")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    assert collector.profile_dir() == str(tmp_path / "tmp" / "mxtpu_profile")
    kv = distributed.FileKV(str(tmp_path / "gang"))
    c = collector.HostCollector(path=log, kv=kv, rank=0, world=1)
    collector.request_profile(kv, 0, steps=2)
    c.poll_once()
    traces = list((tmp_path / "tmp" / "mxtpu_profile").glob(
        "rank0-*/trace.json"))
    assert len(traces) == 1 and json.load(open(traces[0]))
    assert not list(work.iterdir())
