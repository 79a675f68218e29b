"""The port's resilient training (``mxnet_tpu_torch/resilience.py``,
``checkpoint.py``, ``numerics.py``) against the JAX package's.

``examples/train_resilient.py``'s MLP (``tests/torch_resilient_mlp.py``)
runs under ``run_resilient`` in both packages, from the same weights,
with the same ``MXTPU_FAULT_INJECT`` spec: a SIGTERM preemption (with
injected open failures on the resume's reads), a NaN gradient, and a
crash in the middle of a checkpoint write (a subprocess the fault kills,
then a resume).  The ``RunReport`` fields are equal and the losses agree
within the trainer tolerances.  The watchdog expires at 50 ms, and a
``DivergenceMonitor`` rollback rewinds a seeded loader and quarantines
the streak's batches.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint, numerics, resilience, telemetry
from torch_one_thread import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_resilient_mlp as mlp  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("mxnet_tpu", "mxnet_tpu_torch")


def _arm(spec):
    """Arm (or with None clear) the spec for both packages' plans."""
    if spec is None:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
    else:
        os.environ["MXTPU_FAULT_INJECT"] = spec
    jmx.resilience.reset_faults()
    resilience.reset_faults()


@pytest.fixture
def clean_faults(monkeypatch):
    monkeypatch.setenv("MXTPU_IO_BACKOFF", "0.001")
    yield _arm
    _arm(None)


@pytest.fixture(scope="module")
def weights():
    jmx.random.seed(7)
    _s, get_state, _set, _tr = mlp.build("mxnet_tpu")
    return get_state()


def _resilient(pkg, weights, ckpt_dir, spec, steps=30, nan_step=None):
    mx = jmx if pkg == "mxnet_tpu" else tmx
    step_fn, get_state, set_state, trainer = mlp.build(
        pkg, weights, nan_step=nan_step)
    _arm(spec)
    # synchronous saves: whether an async save is still in flight at the
    # SIGTERM decides where the run resumes, and that is timing
    ck = mx.checkpoint.make_checkpointer(str(ckpt_dir), max_to_keep=3,
                                         async_save=False)
    report = mx.resilience.run_resilient(
        step_fn, ck, steps, get_state=get_state, set_state=set_state,
        checkpoint_every=10, max_restarts=3)
    _arm(None)
    return report, trainer, get_state()


def _same_reports(jr, tr):
    for field in ("final_step", "restarts", "resumed_from", "preempted"):
        assert getattr(tr, field) == getattr(jr, field), field
    assert sorted(tr.losses) == sorted(jr.losses)
    np.testing.assert_allclose([tr.losses[s] for s in sorted(tr.losses)],
                               [jr.losses[s] for s in sorted(jr.losses)],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spec,nan_step", [
    ("sigterm_at_step:25,io_open:2", None),
    (None, 5),
])
def test_resilient_mlp_matches_the_reference(tmp_path, clean_faults,
                                             weights, spec, nan_step):
    runs = {pkg: _resilient(pkg, weights, tmp_path / pkg, spec,
                            nan_step=nan_step) for pkg in PKGS}
    (jr, jtr, jw), (tr, ttr, tw) = runs["mxnet_tpu"], \
        runs["mxnet_tpu_torch"]
    _same_reports(jr, tr)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if spec is not None:
        assert tr.preempted and tr.restarts == 1
        assert tr.resumed_from == [0, 25]
    if nan_step is not None:
        assert [r.step for r in ttr.skipped_steps] == \
            [r.step for r in jtr.skipped_steps] == [nan_step + 1]


def test_crash_during_save_resumes_from_the_previous_checkpoint(
        tmp_path, clean_faults, weights):
    """A subprocess of each package dies in step 20's shard write (exit
    57); the resumed run restores step 10 and replays to the end."""
    wfile = str(tmp_path / "w.npz")
    np.savez(wfile, *weights)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXTPU_")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=_REPO + os.pathsep
               + env.get("PYTHONPATH", ""))
    procs = {pkg: subprocess.Popen(
        [sys.executable, os.path.join(_REPO, "tests",
                                      "torch_resilient_mlp.py"),
         pkg, str(tmp_path / pkg), wfile, "--steps", "20",
         "--crash-after", "15"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in PKGS}
    reports = {}
    for pkg, proc in procs.items():
        _out, err = proc.communicate(timeout=120)
        assert proc.returncode == resilience.CRASH_EXIT_CODE, err
        assert "injected crash at crash_during_save" in err
        d = tmp_path / pkg
        assert sorted(n for n in os.listdir(d) if n.startswith("step_")) \
            == ["step_0000000010", "step_0000000020"]
        assert not (d / "step_0000000020" / "MANIFEST.json").exists()
        reports[pkg] = _resilient(pkg, weights, d, None, steps=20)[0]
    _same_reports(reports["mxnet_tpu"], reports["mxnet_tpu_torch"])
    assert reports["mxnet_tpu_torch"].resumed_from == [10]


def test_watchdog_expires_at_50ms():
    t0 = time.monotonic()
    with pytest.raises(resilience.WatchdogExpired):
        with resilience.Watchdog(0.05, name="hang", dump_stacks=False):
            time.sleep(5)
    assert time.monotonic() - t0 < 2.0
    wd = resilience.Watchdog(0.05, name="quiet", action="none",
                             dump_stacks=False).start()
    time.sleep(0.2)
    wd.cancel()
    assert wd.expired


def test_divergence_rollback_rewinds_the_loader(tmp_path, clean_faults):
    """Two poisoned steps in a row (``max_bad_steps=2``): the monitor
    restores the checkpoint, the loader rewinds to its saved position,
    and the streak's batches are quarantined, so the replay skips
    them."""
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader

    step_fn, get_state, set_state, trainer = mlp.build("mxnet_tpu_torch")
    data = np.arange(64, dtype=np.float32).reshape(32, 2)
    loader = DataLoader(ArrayDataset(data), batch_size=4, shuffle=True,
                        seed=3)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    saved = {}

    def restore(state):
        saved["restored"] = True
        set_state(state)

    mon = numerics.DivergenceMonitor(checkpointer=ck, set_state=restore,
                                     max_bad_steps=2)
    trainer.divergence_monitor = mon
    trainer.attach_data_pipeline(loader)
    assert mon.data_pipeline is loader
    with tmx.cpu():
        it = iter(loader)
    seen = []
    for step in range(6):
        seen.append(next(it))
        if step == 2:
            ck.save(3, get_state(), data_state=loader.state_dict())
            ck.wait()
            saved["sd"] = loader.state_dict()
        if step in (4, 5):
            _arm("nan_grad:1")
        step_fn(step)
    assert saved.get("restored") and mon.recoveries == 1
    assert len(trainer.skipped_steps) == 2
    assert loader.state_dict()["cursor"] == saved["sd"]["cursor"]
    assert sorted(loader._state.quarantined) == [(0, 4), (0, 5)]
    with tmx.cpu():
        replay = [b.asnumpy() for b in loader]
    assert len(replay) == 8 - 3 - 2
    want = [b.asnumpy() for b in seen[3:4]]
    assert np.array_equal(replay[0], want[0])
    assert telemetry.event_counts().get("divergence_rollback", 0) >= 1
