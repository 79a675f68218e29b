"""Whole-step capture (``gluon.captured`` + ``Trainer.train_step``) in the
port, held against the port's own eager step.

The captured step must be a pure performance transform: one dispatch and
one readback per step, bitwise equal to the eager oracle
(``MXTPU_CAPTURED_STEP=0``) in losses, weights and optimizer states,
including skipped (non-finite) steps, clipped steps, amp's loss scale,
gradient accumulation with BatchNorm and Dropout; per-step scalars are
data, so LR schedules and loss-scale changes never record again.  The
matrix is ``tests/test_captured_step.py:96-150``'s.  On the host the
captured step runs without a graph; the tests marked ``gpu`` hold the CUDA
graph itself on the card and skip here.  This file imports torch and the
port only, so it runs on the card's host too
(``pytest --noconftest tests/test_torch_captured.py``).
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, numerics
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import context_of
from mxnet_tpu_torch.gluon import captured, nn
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.optimizer import grouped

STEPS = 10


@pytest.fixture
def env():
    saved = {}

    def set_(**kv):
        for k, v in kv.items():
            saved.setdefault(k, os.environ.get(k))
            os.environ[k] = v

    yield set_
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _make_net(dev, with_bn=False, seed=7):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"))
        if with_bn:
            net.add(nn.BatchNorm(axis=1), nn.Dropout(0.3))
        net.add(nn.Dense(3))
    net.initialize(init=mx.init.Xavier(), ctx=context_of(dev))
    net.hybridize()
    return net


def _batches(steps=STEPS, n=8, d=6, nan_at=None, seed=42):
    rng = np.random.RandomState(seed)
    xs = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(steps)]
    ys = [rng.randint(0, 3, size=(n,)).astype(np.float32)
          for _ in range(steps)]
    if nan_at is not None:
        xs[nan_at][0, 0] = np.nan
    return xs, ys


def _nd(a, dev):
    return NDArray(torch.as_tensor(a, device=dev), context_of(dev))


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _leaves(s)]
    return [state.asnumpy()]


def _run(env, captured_on, dev=torch.device("cpu"), opt="sgd",
         opt_params=None, k=1, clip=None, nan_at=None, loss_scale=None,
         steps=STEPS, with_bn=False):
    env(MXTPU_CAPTURED_STEP="1" if captured_on else "0")
    net = _make_net(dev, with_bn=with_bn)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), opt,
                            dict(opt_params or {"learning_rate": 0.1}),
                            clip_global_norm=clip)
    if loss_scale is not None:
        trainer._amp_loss_scaler = mx.amp.DynamicLossScaler(
            init_scale=loss_scale)
    xs, ys = _batches(steps=steps, nan_at=nan_at)
    losses = []
    for s in range(steps):
        out = trainer.train_step(net, loss_fn, _nd(xs[s], dev),
                                 _nd(ys[s], dev), grad_accum=k)
        losses.append(out.asnumpy())
    weights = [p.data().asnumpy() for p in trainer._params]
    states = {i: _leaves(st)
              for i, st in trainer._updaters[0].states.items()}
    return losses, weights, states, trainer


def _assert_same(a, b):
    for s, (x, y) in enumerate(zip(a[0], b[0])):
        np.testing.assert_array_equal(x, y, err_msg=f"loss step {s}")
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        np.testing.assert_array_equal(x, y, err_msg=f"weight {i}")
    assert set(a[2]) == set(b[2])
    for i in a[2]:
        for x, y in zip(a[2][i], b[2][i]):
            np.testing.assert_array_equal(x, y, err_msg=f"state {i}")


OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        ("adam", {"learning_rate": 0.01}),
        ("lamb", {"learning_rate": 0.01})]


@pytest.mark.parametrize("opt,opt_params", OPTS, ids=[o for o, _ in OPTS])
@pytest.mark.parametrize("guard", ["1", "0"])
def test_bitwise_parity(env, opt, opt_params, guard):
    """Ten captured steps equal ten eager ones to the last bit.  Guard-on
    runs hold a NaN batch (one skipped step on both paths); guard-off runs
    a tight global-norm clip (every step clipped)."""
    env(MXTPU_GRAD_GUARD=guard)
    guard_on = guard == "1"
    kw = dict(opt=opt, opt_params=opt_params,
              nan_at=4 if guard_on else None,
              clip=None if guard_on else 0.5)
    eager = _run(env, False, **kw)
    cap = _run(env, True, **kw)
    _assert_same(eager, cap)
    if guard_on:
        assert [r.step for r in eager[3].skipped_steps] == \
            [r.step for r in cap[3].skipped_steps] == [5]


@pytest.mark.parametrize("case", ["grad_accum_bn_dropout", "amp_loss_scale"])
def test_bitwise_parity_accum_and_amp(env, case):
    """grad_accum=2 with BatchNorm (running statistics moved once a
    microbatch) and Dropout (one generator a microbatch); and a dynamic
    loss scale halved by the skipped NaN step on both paths."""
    env(MXTPU_GRAD_GUARD="1")
    if case == "grad_accum_bn_dropout":
        kw = dict(opt="adam", opt_params={"learning_rate": 0.01}, k=2,
                  with_bn=True, steps=6)
    else:
        kw = dict(opt="sgd", opt_params={"learning_rate": 0.1}, nan_at=3,
                  loss_scale=1024.0)
    eager = _run(env, False, **kw)
    cap = _run(env, True, **kw)
    _assert_same(eager, cap)
    if case == "amp_loss_scale":
        assert eager[3]._amp_loss_scaler.loss_scale == \
            cap[3]._amp_loss_scaler.loss_scale < 1024.0


def _trainer(dev, opt="adam"):
    net = _make_net(dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), opt,
                            {"learning_rate": 0.01})
    return net, loss_fn, trainer


@pytest.mark.parametrize("k", [1, 4])
def test_one_dispatch_one_readback_per_step(env, k):
    """A healthy captured step is ONE dispatch (no grouped update
    dispatches) and ONE host readback (the guard, after the update)."""
    env(MXTPU_CAPTURED_STEP="1", MXTPU_GRAD_GUARD="1")
    dev = torch.device("cpu")
    net, loss_fn, trainer = _trainer(dev)
    xs, ys = _batches(steps=5)
    trainer.train_step(net, loss_fn, _nd(xs[0], dev), _nd(ys[0], dev),
                       grad_accum=k)
    captured.reset_counters()
    grouped.reset_dispatch_count()
    numerics.reset_readback_count()
    for s in range(1, 5):
        trainer.train_step(net, loss_fn, _nd(xs[s], dev), _nd(ys[s], dev),
                           grad_accum=k)
    assert captured.dispatch_count() == 4
    assert grouped.dispatch_count() == 0
    assert numerics.readback_count() == 4
    assert captured.trace_count() == 0
    assert captured.cache_stats() == {"hits": 4, "misses": 0}


def _schedule_run(dev, k):
    net, loss_fn, trainer = _trainer(dev)
    trainer._amp_loss_scaler = mx.amp.DynamicLossScaler(init_scale=256.0)
    xs, ys = _batches(steps=8)
    captured.reset_counters()
    losses = []
    for s in range(8):
        trainer.set_learning_rate(0.01 * (0.9 ** s))     # schedule tick
        if s == 3:
            trainer._amp_loss_scaler.loss_scale *= 2     # scale change
        losses.append(trainer.train_step(
            net, loss_fn, _nd(xs[s], dev), _nd(ys[s], dev),
            grad_accum=k).asnumpy())
    return losses, [p.data().asnumpy() for p in trainer._params]


@pytest.mark.parametrize("k", [1, 4])
def test_no_retrace_on_schedule_ticks(env, k):
    """LR ticks, a loss-scale change and the optimizer's time step are
    data: one recording a configuration, ever."""
    env(MXTPU_CAPTURED_STEP="1", MXTPU_GRAD_GUARD="1")
    _schedule_run(torch.device("cpu"), k)
    assert captured.trace_count() == 1
    assert captured.cache_stats() == {"hits": 7, "misses": 1}
    assert captured.dispatch_count() == 8


def test_capture_cache_size_env_and_eviction_events(env, monkeypatch):
    """``MXTPU_CAPTURE_CACHE`` (at least 1) bounds the signatures a trainer
    keeps; each eviction emits ``capture_cache_evict`` and releases the
    evicted step's graph and pool."""
    from mxnet_tpu_torch import telemetry

    env(MXTPU_CAPTURED_STEP="1", MXTPU_CAPTURE_CACHE="0")
    assert captured.capture_cache_size() == 1
    env(MXTPU_CAPTURE_CACHE="2")
    assert captured.capture_cache_size() == 2
    released = []
    real = captured.CapturedStep.release
    monkeypatch.setattr(captured.CapturedStep, "release",
                        lambda self: (released.append(self), real(self)))
    telemetry.reset()
    dev = torch.device("cpu")
    net, loss_fn, trainer = _trainer(dev)
    rng = np.random.RandomState(0)
    for n in (4, 5, 6, 4):             # four signatures, two evictions
        x = rng.normal(size=(n, 6)).astype(np.float32)
        y = rng.randint(0, 3, size=(n,)).astype(np.float32)
        trainer.train_step(net, loss_fn, _nd(x, dev), _nd(y, dev))
    assert len(trainer._captured_cache) == 2
    assert len(set(trainer._captured_fast.values())) == 2
    assert len(released) == 2
    assert all(s._graph is None and s._static is None for s in released)
    assert telemetry.event_counts().get("capture_cache_evict") == 2
    telemetry.reset()


def _knob_run(env, change):
    env(MXTPU_CAPTURED_STEP="1", MXTPU_REMAT="", MXTPU_GROUP_MAX_ITEMS="")
    net, loss_fn, trainer = _trainer(torch.device("cpu"))
    xs, ys = _batches(steps=6)
    captured.reset_counters()
    losses, groups = [], []
    for s in range(6):
        if change and s == 2:
            env(MXTPU_GROUP_MAX_ITEMS="1")
        if change and s == 4:
            env(MXTPU_REMAT="full")
        losses.append(trainer.train_step(
            net, loss_fn, _nd(xs[s], torch.device("cpu")),
            _nd(ys[s], torch.device("cpu"))).asnumpy())
        step = next(iter(trainer._captured_fast.values())) \
            if len(trainer._captured_fast) == 1 else \
            list(trainer._captured_fast.values())[-1]
        groups.append(len(step._groups))
    states = {i: _leaves(st)
              for i, st in trainer._updaters[0].states.items()}
    return (losses, [p.data().asnumpy() for p in trainer._params], states,
            captured.cache_stats()["misses"], groups)


def test_changed_remat_or_group_cap_recaptures_bitwise(env):
    """A changed ``MXTPU_GROUP_MAX_ITEMS`` (a split plan) and a changed
    ``MXTPU_REMAT`` each miss the capture cache once and record again;
    both leave the numbers as they are, so the run is bitwise the one
    that changed neither."""
    changed = _knob_run(env, True)
    plain = _knob_run(env, False)
    assert changed[3] == 3 and plain[3] == 1
    assert changed[4] == [1, 1, 4, 4, 4, 4] and plain[4] == [1] * 6
    _assert_same(changed[:3], plain[:3])


def test_cast_and_hybridize_invalidate_the_capture(env):
    """A parameter's tensor replaced (cast) or hybridize again bumps the
    block's cache version: the next step records anew."""
    env(MXTPU_CAPTURED_STEP="1", MXTPU_GRAD_GUARD="1")
    dev = torch.device("cpu")
    net, loss_fn, trainer = _trainer(dev, "sgd")
    xs, ys = _batches(steps=4)
    captured.reset_counters()
    for s in range(2):
        trainer.train_step(net, loss_fn, _nd(xs[s], dev), _nd(ys[s], dev))
    assert captured.cache_stats() == {"hits": 1, "misses": 1}
    v0 = captured._tree_version(net)
    net.cast("float64")
    assert captured._tree_version(net) != v0
    trainer.train_step(net, loss_fn, _nd(xs[2].astype(np.float64), dev),
                       _nd(ys[2], dev))
    assert captured.cache_stats()["misses"] == 2
    net.hybridize()
    trainer.train_step(net, loss_fn, _nd(xs[3].astype(np.float64), dev),
                       _nd(ys[3], dev))
    assert captured.cache_stats()["misses"] == 3
    assert trainer._params[0].data()._data.dtype == torch.float64


def test_fallbacks_run_eagerly(env):
    """Not hybridized, MXTPU_CAPTURED_STEP=0, an optimizer without a
    grouped plan, MXTPU_FUSED_STEP=0: the eager path runs, and trains;
    a batch grad_accum does not divide is refused (test_captured_step.py:
    280, 306)."""
    env(MXTPU_CAPTURED_STEP="1")
    dev = torch.device("cpu")
    net, loss_fn, trainer = _trainer(dev, "sgd")
    xs, ys = _batches(steps=5)
    captured.reset_counters()
    net._active = False
    net(_nd(xs[0], dev))          # deferred shapes
    w0 = trainer._params[0].data().asnumpy().copy()
    out = trainer.train_step(net, loss_fn, _nd(xs[0], dev), _nd(ys[0], dev))
    assert np.isfinite(out.asnumpy()).all()
    assert not (trainer._params[0].data().asnumpy() == w0).all()
    assert captured.ineligible_reason(trainer, net, loss_fn,
                                      _nd(xs[0], dev), 1) == \
        "block is not hybridized"
    net.hybridize()
    env(MXTPU_CAPTURED_STEP="0")
    trainer.train_step(net, loss_fn, _nd(xs[1], dev), _nd(ys[1], dev))
    env(MXTPU_CAPTURED_STEP="1", MXTPU_FUSED_STEP="0")
    assert "MXTPU_FUSED_STEP=0" in captured.ineligible_reason(
        trainer, net, loss_fn, _nd(xs[2], dev), 1)
    trainer.train_step(net, loss_fn, _nd(xs[2], dev), _nd(ys[2], dev))
    env(MXTPU_FUSED_STEP="1")
    nadam = gluon.Trainer(net.collect_params(), "nadam",
                          {"learning_rate": 0.01})
    assert "no grouped plan" in captured.ineligible_reason(
        nadam, net, loss_fn, _nd(xs[3], dev), 1)
    nadam.train_step(net, loss_fn, _nd(xs[3], dev), _nd(ys[3], dev))
    assert captured.dispatch_count() == 0
    x6 = _nd(np.random.RandomState(0).normal(size=(6, 6))
             .astype(np.float32), dev)
    assert "divisible" in captured.ineligible_reason(trainer, net, loss_fn,
                                                     x6, 4)
    with pytest.raises(ValueError, match="divisible"):
        trainer.train_step(net, loss_fn, x6, _nd(np.zeros(6, np.float32),
                                                 dev), grad_accum=4)


# -- on the card: the CUDA graph -----------------------------------------------

@pytest.mark.gpu
def test_graph_replay_bitwise_equals_eager_on_the_card(env):
    """The CUDA graph's replays against the eager step under deterministic
    algorithms: Adam with the guard and a NaN batch, and grad_accum=2 with
    BatchNorm and Dropout (the generators registered with the graph)."""
    dev = _card()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        env(MXTPU_GRAD_GUARD="1")
        for kw in (dict(opt="adam", opt_params={"learning_rate": 0.01},
                        nan_at=4),
                   dict(opt="adam", opt_params={"learning_rate": 0.01},
                        k=2, with_bn=True, steps=6)):
            eager = _run(env, False, dev, **kw)
            captured.reset_counters()
            cap = _run(env, True, dev, **kw)
            _assert_same(eager, cap)
            assert captured.trace_count() == 1
            assert captured.dispatch_count() == kw.get("steps", STEPS)
    finally:
        torch.use_deterministic_algorithms(prev)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_graph_not_recorded_again_on_ticks_on_the_card(env, k):
    """LR and loss-scale ticks replay the one graph, and the replays equal
    the eager steps."""
    dev = _card()
    env(MXTPU_GRAD_GUARD="1", MXTPU_CAPTURED_STEP="1")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cap = _schedule_run(dev, k)
        assert captured.trace_count() == 1
        assert captured.dispatch_count() == 8
        env(MXTPU_CAPTURED_STEP="0")
        eager = _schedule_run(dev, k)
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(cap[0] + cap[1], eager[0] + eager[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_graph_recorded_again_after_cast_on_the_card(env):
    dev = _card()
    env(MXTPU_GRAD_GUARD="1", MXTPU_CAPTURED_STEP="1")
    net, loss_fn, trainer = _trainer(dev, "sgd")
    xs, ys = _batches(steps=3)
    captured.reset_counters()
    for s in range(2):
        trainer.train_step(net, loss_fn, _nd(xs[s], dev), _nd(ys[s], dev))
    assert captured.trace_count() == 1
    net.cast("float64")
    out = trainer.train_step(net, loss_fn,
                             _nd(xs[2].astype(np.float64), dev),
                             _nd(ys[2], dev))
    assert captured.trace_count() == 2
    assert np.isfinite(out.asnumpy()).all()


@pytest.mark.gpu
def test_capture_failure_raises_on_the_card(env):
    """A step that reads a value back to the host cannot be recorded: the
    capture raises MXNetError and does not fall back to the eager path."""
    dev = _card()
    env(MXTPU_GRAD_GUARD="1", MXTPU_CAPTURED_STEP="1")
    net, _loss, trainer = _trainer(dev, "sgd")

    def syncing_loss(out, label):
        if float(out.sum()) > 1e30:             # a host readback
            out = out * 2
        return ((out - label.reshape((-1, 1))) ** 2).sum(axis=1)

    xs, ys = _batches(steps=1)
    net(_nd(xs[0], dev))                      # deferred shapes
    captured.reset_counters()
    w0 = trainer._params[0].data().asnumpy().copy()
    with pytest.raises(MXNetError, match="capturing the train step"):
        trainer.train_step(net, syncing_loss, _nd(xs[0], dev),
                           _nd(ys[0], dev))
    assert captured.dispatch_count() == 0
    np.testing.assert_array_equal(trainer._params[0].data().asnumpy(), w0)



def _bert_run(env, captured_on, dev, remat=None, steps=3):
    """``steps`` train_steps of a flash bert_tiny (dropout 0.1, two labels
    as a tuple) hybridized with ``remat``; returns host losses, weights
    and optimizer states."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    env(MXTPU_CAPTURED_STEP="1" if captured_on else "0")
    net = bert.bert_tiny(scan_layers=True, attention_impl="flash",
                         dropout=0.1, device=dev)
    net.initialize(generator=torch.Generator(device=dev).manual_seed(3))
    net.hybridize(**({"remat": remat} if remat else {}))
    trainer = gluon.Trainer(net.collect_params(), "adamw",
                            {"learning_rate": 1e-3, "wd": 0.01})
    rng = np.random.RandomState(5)
    tok = rng.randint(0, 1024, (4, 64))
    mlm = np.where(rng.rand(4, 64) < 0.3, rng.randint(0, 1024, (4, 64)), -1)
    nsp = rng.randint(0, 2, (4,))
    tok, mlm, nsp = (NDArray(torch.as_tensor(a, device=dev),
                             context_of(dev)) for a in (tok, mlm, nsp))
    loss_fn = bert.BERTPretrainLoss()
    mx.random.seed(11)
    losses = [trainer.train_step(net, loss_fn, tok, (mlm, nsp)).asnumpy()
              for _ in range(steps)]
    weights = [p.data().asnumpy() for p in net.collect_params().values()]
    states = [s.asnumpy() for i in sorted(trainer._updaters[0].states)
              for s in trainer._updaters[0].states[i]]
    return losses, weights, states


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [None, "full"])
def test_graph_replays_the_flash_kernels_on_the_card(env, remat):
    """A transformer step whose forward and backward launch the
    hand-written flash kernels, recorded once as a CUDA graph (with the
    recompute of a rematerialised forward inside it) and replayed: equal
    to the eager steps bitwise, dropout included."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    dev = _card()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        eager = _bert_run(env, False, dev, remat)
        captured.reset_counters()
        fa.flash_attention_fwd.launches = 0
        cap = _bert_run(env, True, dev, remat)
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(sum(eager, []), sum(cap, [])):
        np.testing.assert_array_equal(a, b)
    assert captured.trace_count() == 1 and captured.dispatch_count() == 3
    # the warm-up and the recording launch; the replays reach no wrapper
    per_run = 2 * 2 * (2 if remat else 1)
    assert fa.flash_attention_fwd.launches == per_run
