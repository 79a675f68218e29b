"""The port's autotuner (``mxnet_tpu_torch/autotune/``) against the JAX
package's: the knob space, the candidate order, ``entry_key``, the
database's bytes and its torn-tail and corrupt-line handling, and a
deterministic ``successive_halving`` run are the same in both; an
out-of-memory candidate is infeasible; and ``MXTPU_AUTOTUNE=search`` then
``replay`` through ``Trainer.train_step`` on a tiny net applies the stored
winner with zero trials, bitwise equal to the untuned run.
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import resilience as jresilience
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.autotune import db as jdb
from mxnet_tpu.autotune import runner as jrunner
from mxnet_tpu.autotune import search as jsearch
from mxnet_tpu.autotune import space as jspace

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autotune, gluon, resilience, telemetry
from mxnet_tpu_torch.autotune import db, runner, search, space
from mxnet_tpu_torch.context import context_of
from mxnet_tpu_torch.gluon import captured, nn
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from torch_one_thread import one_torch_thread  # noqa: F401

_TUNE_ENVS = [k.env for k in space.KNOBS.values()] + [
    "MXTPU_AUTOTUNE", "MXTPU_TUNE_DB", "MXTPU_TUNE_BUDGET",
    "MXTPU_TUNE_STEPS", "MXTPU_TUNE_SEMANTICS", "MXTPU_FAULT_INJECT",
    "MXTPU_COMPILE_CACHE_DIR", "MXTPU_CAPTURED_STEP"]


@pytest.fixture(autouse=True)
def _tune_clean():
    """The tuner writes os.environ itself: scrub its variables and both
    packages' telemetry and fault plans around every test."""
    saved = {e: os.environ.pop(e, None) for e in _TUNE_ENVS}
    telemetry.reset()
    jtelemetry.reset()
    resilience.reset_faults()
    jresilience.reset_faults()
    yield
    for e in _TUNE_ENVS:
        os.environ.pop(e, None)
    for e, v in saved.items():
        if v is not None:
            os.environ[e] = v
    telemetry.reset()
    jtelemetry.reset()
    resilience.reset_faults()
    jresilience.reset_faults()


def _arm(spec):
    os.environ["MXTPU_FAULT_INJECT"] = spec
    resilience.reset_faults()
    jresilience.reset_faults()


def test_knob_space_matches_jax():
    """The same knobs in the same order with the same environment
    variables, domains, defaults, layers and safety flags, so a config
    and its fingerprint mean the same in both packages."""
    def decl(sp):
        return [(k.name, k.env, k.domain, k.default, k.layer,
                 k.numerics_preserving) for k in sp.KNOBS.values()]

    assert decl(space) == decl(jspace)
    assert space.fingerprint(space.default_config()) == \
        jspace.fingerprint(jspace.default_config())
    os.environ["MXTPU_REMAT"] = "dots"
    os.environ["MXTPU_GROUP_MAX_ITEMS"] = "8"
    assert space.program_knob_values() == jspace.program_knob_values()
    assert space.current_config() == jspace.current_config()
    # the port searches only knobs a consumer reads: the bucket budget
    # and the FSDP size are read by the store and the sharded trainer
    live = [k.name for k in space.searchable_knobs()]
    assert live == [k.name for k in jspace.searchable_knobs()]
    assert {"allreduce_bucket_mb", "fsdp_min_size"} <= set(live)


@pytest.mark.parametrize("semantics", ["0", "1"])
def test_candidate_order_matches_jax(semantics):
    os.environ["MXTPU_TUNE_SEMANTICS"] = semantics
    bases = [space.default_config(),
             dict(space.default_config(), remat="full", device_prefetch="0",
                  shm_slot_mb="64", grad_accum="4"),
             dict(space.default_config(), remat="not_a_policy")]
    for base in bases:
        names = [k.name for k in jspace.searchable_knobs()]
        got = search.candidates(base, [space.KNOBS[n] for n in names])
        want = jsearch.candidates(base, [jspace.KNOBS[n] for n in names])
        assert got == want
        assert [space.fingerprint(c) for c in got] == \
            [jspace.fingerprint(c) for c in want]


def test_entry_key_and_database_bytes_match_jax(tmp_path, monkeypatch):
    """The same records give the same file, byte for byte, and each
    package reads the other's."""
    monkeypatch.setattr(time, "time", lambda: 1234567.25)
    cfg = space.default_config()
    for args in (("abcd1234", "cpu", (("dp", 8),)),
                 ("abcd1234", "NVIDIA H100 80GB HBM3", None)):
        assert db.entry_key(*args) == jdb.entry_key(*args)
    paths = {}
    for name, d in (("port", db), ("jax", jdb)):
        path = str(tmp_path / f"{name}.jsonl")
        d.record("k1|cpu|single", cfg, 123.4, path=path, mfu=0.1,
                 trials=5, default_score_us=150.0)
        d.record("k0|cpu|dp=2", dict(cfg, remat="dots"), 99.0, path=path)
        d.record("k1|cpu|single", dict(cfg, group_max_items="8"), 88.5,
                 path=path, trials=7)
        paths[name] = path
    port_bytes = open(paths["port"], "rb").read()
    assert port_bytes == open(paths["jax"], "rb").read()
    assert db.load(paths["jax"]) == jdb.load(paths["port"])
    assert db.lookup("k1|cpu|single", paths["jax"])["config"][
        "group_max_items"] == "8"


def test_torn_tail_and_corrupt_lines_match_jax(tmp_path, monkeypatch):
    """A torn last line, an injected bit-rot line (``corrupt_tune_db``)
    and a stale schema read as absent with one ``tune_db_fallback`` a
    load in both packages; the next write drops them."""
    monkeypatch.setattr(time, "time", lambda: 42.0)
    cfg = space.default_config()
    out = {}
    for name, d, tel in (("port", db, telemetry), ("jax", jdb, jtelemetry)):
        path = str(tmp_path / f"{name}.jsonl")
        _arm("corrupt_tune_db:1")
        d.record("bad|cpu|single", cfg, 1.0, path=path)
        d.record("good|cpu|single", cfg, 2.0, path=path)
        with open(path, "a", encoding="utf-8") as f:
            stale = {"db_version": d.DB_VERSION - 1, "key": "old",
                     "config": cfg, "fingerprint": "x", "score_us": 1.0,
                     "t": 0}
            f.write(d._encode(stale))
            f.write('{"crc": 123, "payl')
        loaded = d.load(path)
        fallbacks = tel.event_counts().get("tune_db_fallback")
        d.record("new|cpu|single", cfg, 3.0, path=path)
        out[name] = (sorted(loaded), fallbacks, sorted(d.load(path)),
                     open(path, "rb").read())
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["good|cpu|single"]
    assert out["port"][2] == ["good|cpu|single", "new|cpu|single"]


def _scored(sp, run_mod):
    """A ``run_trial`` whose score is a fixed function of the config and
    the rung's steps: successive halving becomes deterministic."""
    log = []

    def run_trial(step_fn, config, steps=None, warmup=1):
        fp = sp.fingerprint(config)
        log.append((fp, steps))
        if config.get("shm_slot_mb") == "16":
            return run_mod.TrialResult(config, fp, feasible=False,
                                       score_us=math.inf)
        score = sum(len(f"{k}={v}") * (i + 1) for i, (k, v) in
                    enumerate(sorted(config.items()))) % 97 + 10.0 / steps
        return run_mod.TrialResult(config, fp, feasible=True,
                                   score_us=float(score), steps=steps)

    return run_trial, log


@pytest.mark.parametrize("budget", [3, 6, 12])
def test_successive_halving_winner_matches_jax(budget, monkeypatch):
    names = [k.name for k in jspace.searchable_knobs()]
    got_fn, got_log = _scored(space, runner)
    want_fn, want_log = _scored(jspace, jrunner)
    monkeypatch.setattr(search._runner, "run_trial", got_fn)
    monkeypatch.setattr(jsearch._runner, "run_trial", want_fn)
    got_w, got_r = search.successive_halving(
        None, knobs=[space.KNOBS[n] for n in names], total_budget=budget,
        rung_steps=2)
    want_w, want_r = jsearch.successive_halving(
        None, knobs=[jspace.KNOBS[n] for n in names], total_budget=budget,
        rung_steps=2)
    assert got_log == want_log and len(got_r) == budget
    assert (got_w.fingerprint, got_w.score_us, got_w.feasible) == \
        (want_w.fingerprint, want_w.score_us, want_w.feasible)


def test_out_of_memory_is_infeasible_not_a_crash():
    """The ``tune_oom`` fault site and a real allocator error (a
    ``torch.cuda.OutOfMemoryError``, also chained under a wrapper) score
    +inf and undo the trial's environment; other errors propagate."""
    _arm("tune_oom:1")
    cfg = dict(space.default_config(), remat="dots")
    res = runner.run_trial(lambda: None, cfg, steps=2)
    assert not res.feasible and res.score_us == math.inf
    assert "RESOURCE_EXHAUSTED" in res.error
    assert os.environ.get("MXTPU_REMAT") is None

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried ...")

    def wrapped():
        try:
            oom()
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError("step failed") from e

    for fn in (oom, wrapped):
        res = runner.run_trial(fn, cfg, steps=1)
        assert not res.feasible
    assert telemetry.event_counts().get("tune_infeasible") == 3
    with pytest.raises(ValueError):
        runner.run_trial(lambda: (_ for _ in ()).throw(ValueError("x")),
                         cfg, steps=1)


def _net(seed=7):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.Dense(3))
    net.initialize(init=mx.init.Xavier(), ctx=context_of(torch.device("cpu")))
    net.hybridize()
    return net


def _train(steps=4):
    net = _net()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    rng = np.random.RandomState(42)
    cpu = torch.device("cpu")
    losses = []
    for _ in range(steps):
        x = rng.normal(size=(8, 6)).astype(np.float32)
        y = rng.randint(0, 3, size=(8,)).astype(np.float32)
        losses.append(trainer.train_step(
            net, loss_fn, NDArray(torch.as_tensor(x), context_of(cpu)),
            NDArray(torch.as_tensor(y), context_of(cpu))).asnumpy())
    return losses, [p.data().asnumpy() for p in trainer._params], trainer


def test_search_then_replay_through_train_step_bitwise(tmp_path):
    """``search`` runs the trials on the live trainer and stores the
    winner; a fresh trainer under ``replay`` applies it with zero trials,
    and its run is bitwise the untuned one with the same knobs applied
    (every searched knob keeps the numbers)."""
    path = str(tmp_path / "tune_db.jsonl")
    # every candidate runs: the base and two values of each of the five
    # live one-card knobs and the two multi-GPU ones, remat,
    # group_max_items and unique_bucket
    n = len(search.candidates(space.default_config()))
    assert n == 12
    os.environ.update(MXTPU_TUNE_DB=path, MXTPU_TUNE_STEPS="1",
                      MXTPU_TUNE_BUDGET=str(n), MXTPU_CAPTURED_STEP="1")
    os.environ["MXTPU_AUTOTUNE"] = "search"
    captured.reset_counters()
    _l, _w, tuned = _train()
    counts = telemetry.event_counts()
    assert counts.get("tune_trial") == n and counts.get("tune_winner") == 1
    # the base, then remat, group_max_items and unique_bucket record anew
    assert [r.config for r in tuned._autotune_results] == \
        search.candidates(space.default_config())
    assert captured.cache_stats()["misses"] == 4
    (entry,) = db.load(path).values()
    assert entry["trials"] == n and entry["score_us"] < math.inf
    assert entry["key"].split("|")[1:] == ["cpu", "single"]
    assert len(telemetry.recent_steps()) == 4      # trials are marked
    for k in space.KNOBS.values():
        os.environ.pop(k.env, None)

    os.environ["MXTPU_AUTOTUNE"] = "replay"
    telemetry.reset()
    captured.reset_counters()
    losses_rep, weights_rep, _t = _train()
    counts = telemetry.event_counts()
    assert counts.get("tune_db_hit") == 1 and "tune_trial" not in counts
    assert space.current_config() == entry["config"]
    assert captured.cache_stats()["misses"] == 1

    os.environ["MXTPU_AUTOTUNE"] = "off"
    space.apply_config(entry["config"])
    losses_off, weights_off, _t = _train()
    for k in space.KNOBS.values():
        os.environ.pop(k.env, None)
    losses_def, weights_def, _t = _train()
    for a, b, c in zip(losses_rep, losses_off, losses_def):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for a, b, c in zip(weights_rep, weights_off, weights_def):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_sharded_trainer_replays_a_stored_winner(tmp_path):
    """``ShardedTrainer`` consults the database before its first step
    (replay only): a stored entry for its signature is applied."""
    from mxnet_tpu_torch import parallel

    path = str(tmp_path / "tune_db.jsonl")
    os.environ["MXTPU_TUNE_DB"] = path
    model = torch.nn.Linear(4, 2)
    tr = parallel.ShardedTrainer(model, torch.nn.MSELoss(reduction="none"),
                                 "sgd", {"learning_rate": 0.1})
    x = np.ones((4, 4), np.float32)
    y = np.zeros((4, 2), np.float32)
    tr._stage(x)
    sig = autotune.sharded_signature(tr, x)
    key = db.entry_key(sig, autotune.device_kind(), None)
    db.record(key, dict(space.default_config(), remat="full"), 10.0)
    tr._initialized = False
    tr.step(x, y)
    assert os.environ.get("MXTPU_REMAT") == "full"
    assert telemetry.event_counts().get("tune_db_hit") == 1
    assert json.loads(open(path).read())["crc"]
