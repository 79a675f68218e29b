"""The port's Gluon training surface against the JAX package's, on the CPU.

- ``Trainer.step`` on the small BottleneckV1 ResNet (the eager MXNet loop:
  ``record``, ``backward``, ``step``), three SGD steps: losses, trained
  weights, running statistics and momenta;
- ``Trainer.train_step`` on a small MLP over the guard (a NaN batch skips
  the same step in both), the global-norm clip, amp's loss scale and
  gradient accumulation with BatchNorm;
- ``kvstore`` push/pull, ``gluon.utils``, ``amp.DynamicLossScaler`` and
  ``numerics`` against the JAX package;
- the Trainer's own contract: the stale-gradient check, the optimizer-state
  round trip and the refusals of ``test_grouped_optimizer.py:286-311``,
  the learning-rate controls, and what waits for later slices.

Tolerances: rtol 2e-4 / atol 2e-5 on values and losses, 2e-3 / 2e-4 on
trained weights.  The ResNet trains from the point test_torch_resnet.py's
f64 scan shows clear of ReLU and max-pool kinks (``SEEDS``), where no
order of a sum can send an f32 run to another side.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from test_torch_resnet import (GRAD_ATOL, GRAD_RTOL, SEEDS, _jax_net,
                               _numpy_params, _port_net, _small)
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def env():
    """Set environment variables for a test and restore them after."""
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


def _by_name(net):
    return {k[len(net.prefix):]: p for k, p in net.collect_params().items()}


def test_trainer_step_resnet_matches_jax():
    """Three eager Gluon steps (record, backward, Trainer.step) from
    test_sharded_trainer_matches_jax's kink-free point (seed 52, lr 0.1:
    its f64 scan applies, the trajectory being the same)."""
    seed = SEEDS[1]
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    jnet = _jax_net(_small, x, seed=seed)
    tnet = _port_net(_small, _numpy_params(jnet))
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt),
                         kvstore="device")
    jl_fn, tl_fn = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        tgluon.loss.SoftmaxCrossEntropyLoss()
    jl_fn.hybridize()                  # the JAX loss one program as well
    want, got = [], []
    for _ in range(3):
        with jag.record():
            jl = jl_fn(jnet(jnd.array(x)), jnd.array(y))
        jl.backward()
        jtr.step(4)
        want.append(jl.asnumpy())
        with cpu():
            with tag.record():
                tl = tl_fn(tnet(tnd.array(x)), tnd.array(y))
            tl.backward()
            ttr.step(4)
        got.append(tl.asnumpy())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[-1].mean() < got[0].mean()
    jp, tp = _by_name(jnet), _by_name(tnet)
    assert list(jp) == list(tp)
    for name in jp:
        tol = (RTOL, ATOL) if jp[name].grad_req == "null" else \
            (GRAD_RTOL, GRAD_ATOL)
        np.testing.assert_allclose(tp[name].data().asnumpy(),
                                   jp[name].data().asnumpy(), rtol=tol[0],
                                   atol=tol[1], err_msg=name)
    jst, tst = jtr._updaters[0].states, ttr._updaters[0].states
    assert set(jst) == set(tst)
    for i in jst:
        np.testing.assert_allclose(tst[i].asnumpy(), jst[i].asnumpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _mlp(pkg, with_bn):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6))
        if with_bn:
            net.add(nn.BatchNorm(axis=1, in_channels=16))
        net.add(nn.Dense(3, in_units=16))
    return net


def _twin_mlps(with_bn, seed=7):
    """The JAX MLP and the port's, with the same weights."""
    jmx.random.seed(seed)
    jnet = _mlp(jmx, with_bn)
    jnet.initialize(init=jmx.init.Xavier())
    jnet.hybridize()
    with cpu():
        tnet = _mlp(tmx, with_bn)
        tnet.initialize()
    tmx.convert.load_gluon_params(tnet, _numpy_params(jnet))
    tnet.hybridize()
    return jnet, tnet


TRAIN_STEP_CASES = {
    "sgd-guard-nan": dict(opt="sgd", hp={"learning_rate": 0.1,
                                         "momentum": 0.9}, nan_at=2),
    "adam-clip": dict(opt="adam", hp={"learning_rate": 0.01}, clip=0.5,
                      guard="0"),
    "lamb-accum-bn": dict(opt="lamb", hp={"learning_rate": 0.01}, k=2,
                          with_bn=True),
    "sgd-amp-nan": dict(opt="sgd", hp={"learning_rate": 0.1}, nan_at=1,
                        loss_scale=1024.0),
}


def _train_step_batches(c):
    rng = np.random.RandomState(9)
    for s in range(5):
        x = rng.standard_normal((8, 6)).astype(np.float32)
        y = rng.randint(0, 3, 8).astype(np.float32)
        if s == c.get("nan_at"):
            x[0, 0] = np.nan
        yield x, y


@pytest.fixture(scope="module")
def jax_train_steps():
    """Each case's JAX run, once for both of the port's paths: five
    train_steps through the JAX package's captured step (its tests hold
    it bitwise to its eager oracle), from the weights the port's twin
    starts at.  Returns ``run(case) -> (start weights, losses, skipped
    steps, loss scale, trained weights)``."""
    runs = {}

    def run(case):
        if case in runs:
            return runs[case]
        c = TRAIN_STEP_CASES[case]
        saved = {k: os.environ.get(k) for k in ("MXTPU_GRAD_GUARD",
                                                "MXTPU_CAPTURED_STEP")}
        os.environ.update(MXTPU_GRAD_GUARD=c.get("guard", "1"),
                          MXTPU_CAPTURED_STEP="1")
        try:
            jnet, _ = _twin_mlps(c.get("with_bn", False))
            start = _numpy_params(jnet)
            jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
            jloss.hybridize()
            jtr = jgluon.Trainer(jnet.collect_params(), c["opt"],
                                 dict(c["hp"]),
                                 clip_global_norm=c.get("clip"))
            if "loss_scale" in c:
                jtr._amp_loss_scaler = jmx.amp.DynamicLossScaler(
                    init_scale=c["loss_scale"])
            losses = [jtr.train_step(jnet, jloss, jnd.array(x),
                                     jnd.array(y),
                                     grad_accum=c.get("k", 1)).asnumpy()
                      for x, y in _train_step_batches(c)]
            scale = jtr._amp_loss_scaler.loss_scale \
                if "loss_scale" in c else None
            runs[case] = (start, losses,
                          [r.step for r in jtr.skipped_steps], scale,
                          {k: p.data().asnumpy()
                           for k, p in _by_name(jnet).items()})
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return runs[case]

    return run


@pytest.mark.parametrize("case", sorted(TRAIN_STEP_CASES))
@pytest.mark.parametrize("captured_on", ["1", "0"])
def test_train_step_matches_jax(env, jax_train_steps, case, captured_on):
    """Five train_steps on the MLP in both packages: losses, weights, the
    skipped steps and the loss scale."""
    c = TRAIN_STEP_CASES[case]
    start, want, skipped, scale, trained = jax_train_steps(case)
    env(MXTPU_GRAD_GUARD=c.get("guard", "1"),
        MXTPU_CAPTURED_STEP=captured_on)
    with cpu():
        tnet = _mlp(tmx, c.get("with_bn", False))
        tnet.initialize()
    tmx.convert.load_gluon_params(tnet, start)
    tnet.hybridize()
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    tloss.hybridize()
    ttr = tgluon.Trainer(tnet.collect_params(), c["opt"], dict(c["hp"]),
                         clip_global_norm=c.get("clip"))
    if "loss_scale" in c:
        ttr._amp_loss_scaler = tmx.amp.DynamicLossScaler(
            init_scale=c["loss_scale"])
    for s, ((x, y), jl) in enumerate(zip(_train_step_batches(c), want)):
        with cpu():
            tl = ttr.train_step(tnet, tloss, tnd.array(x), tnd.array(y),
                                grad_accum=c.get("k", 1))
        np.testing.assert_allclose(tl.asnumpy(), jl, rtol=RTOL,
                                   atol=ATOL, err_msg=f"loss step {s}")
    assert [r.step for r in ttr.skipped_steps] == skipped
    if "nan_at" in c:
        assert len(ttr.skipped_steps) == 1
    if "loss_scale" in c:
        assert ttr._amp_loss_scaler.loss_scale == scale < c["loss_scale"]
    tp = _by_name(tnet)
    for name, w in trained.items():
        np.testing.assert_allclose(tp[name].data().asnumpy(), w,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_skipped_step_leaves_weights_and_states(env):
    """A NaN gradient under the guard: weights, master copies and states
    stay bitwise as they were, and the step counters roll back."""
    env(MXTPU_GRAD_GUARD="1")
    with cpu():
        p = tgluon.Parameter("w_weight", shape=(3, 4), dtype="bfloat16")
        p.initialize()
        tr = tgluon.Trainer([p], "adam", {"learning_rate": 0.1,
                                          "multi_precision": True},
                            kvstore=None)

        def step(nan):
            g = p.grad()
            g._data = torch.randn(3, 4).bfloat16()
            if nan:
                g._data[1, 2] = float("nan")
            p.data()._fresh_grad = True
            tr.step(1)

        def tensors():
            master, (mean, var) = tr._updaters[0].states[0]
            return [t._data.clone() for t in (p.data(), master, mean, var)]

        step(False)
        before, t_before = tensors(), dict(tr._optimizer._index_update_count)
        step(True)
    assert all(torch.equal(a, b) for a, b in zip(tensors(), before))
    assert tr._optimizer._index_update_count == t_before
    assert [r.step for r in tr.skipped_steps] == [2]


def test_stale_gradient_is_refused(env):
    env(MXTPU_GRAD_GUARD="1")
    with cpu():
        net = tgluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        x = tnd.array(np.ones((2, 3), np.float32))
        with pytest.raises(UserWarning, match="has not been updated"):
            tr.step(2)
        with tag.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
        with pytest.raises(UserWarning, match="has not been updated"):
            tr.step(2)
        tr.step(2, ignore_stale_grad=True)


def _adam_params(n=3, shape=(4, 3), seed=0):
    rng = np.random.RandomState(seed)
    params = [tgluon.Parameter(f"w{i}_weight", shape=shape)
              for i in range(n)]
    for p in params:
        p.initialize(ctx=cpu())
        p.set_data(torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)))
    return params


def _step(params, trainer, seed=0):
    rng = np.random.RandomState(seed)
    for p in params:
        p.grad()._data = torch.from_numpy(
            rng.standard_normal(p.shape).astype(np.float32))
        p.data()._fresh_grad = True
    trainer.step(1)


@pytest.mark.parametrize("case", ["roundtrip", "count", "shape"])
def test_save_load_states(tmp_path, case):
    """The round trip restores the states and the next step equals an
    uninterrupted run's; a state file for another parameter list is
    refused (count or shape), as test_grouped_optimizer.py:286-311."""
    params = _adam_params()
    tr = tgluon.Trainer(params, "adam", {"learning_rate": 1e-3},
                        kvstore=None)
    _step(params, tr)
    fname = str(tmp_path / "trainer.states")
    tr.save_states(fname)
    if case == "roundtrip":
        ref = _adam_params()
        ref_tr = tgluon.Trainer(ref, "adam", {"learning_rate": 1e-3},
                                kvstore=None)
        _step(ref, ref_tr)
        _step(ref, ref_tr, seed=1)
        fresh = tgluon.Trainer(_adam_params(), "adam",
                               {"learning_rate": 1e-3}, kvstore=None)
        fresh.load_states(fname)
        for i, (m, v) in tr._updaters[0].states.items():
            m2, v2 = fresh._updaters[0].states[i]
            assert torch.equal(m._data, m2._data)
            assert torch.equal(v._data, v2._data)
        tr.load_states(fname)     # the same trainer: its step counts stay
        _step(params, tr, seed=1)
        for a, b in zip(params, ref):
            assert torch.equal(a.data()._data, b.data()._data)
        return
    other = _adam_params(n=1) if case == "count" else \
        _adam_params(n=2, shape=(5, 2))
    tr3 = tgluon.Trainer(other, "adam", {"learning_rate": 1e-3},
                         kvstore=None)
    match = "parameter list changed" if case == "count" else \
        "does not match the parameter shape"
    with pytest.raises(MXNetError, match=match):
        tr3.load_states(fname)


def test_learning_rate_controls():
    params = _adam_params(n=1)
    tr = tgluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == tr.optimizer.lr == 0.25
    sched = tmx.optimizer.FactorScheduler(step=1, factor=0.5)
    tr2 = tgluon.Trainer(params, "sgd", {"learning_rate": 1.0,
                                         "lr_scheduler": sched})
    with pytest.raises(UserWarning, match="LRScheduler"):
        tr2.set_learning_rate(0.1)
    with pytest.raises(ValueError, match="list or dict of Parameters"):
        tgluon.Trainer([1, 2], "sgd")


def test_what_waits_for_later_slices():
    params = _adam_params(n=1)
    tr = tgluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    # the production planes attach (they refused before that slice)
    plane = tmx.integrity.IntegrityPlane(every=5)
    assert tr.attach_integrity(plane) is tr and tr._integrity_due() is False
    monitored = tgluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    monitored.divergence_monitor = tmx.numerics.DivergenceMonitor()
    pipeline = object()
    monitored.attach_data_pipeline(pipeline)
    assert monitored.divergence_monitor.data_pipeline is pipeline
    # the gang slice's entry points construct (they refused before it)
    server = tmx.distributed.GangKVServer()
    server.stop()
    store = tmx.checkpoint.PeerSnapshotStore(0)
    store.hold_own(1, {"w": np.ones(2, np.float32)})
    assert store.held_steps(0) == [1]
    # the multi-GPU slice's store and compression construct (they refused
    # before it): a dist type keeps its store on one worker, the update
    # in the store
    kv = tmx.kv.create("dist_sync")
    assert kv.type == "dist_sync" and kv.num_workers == 1
    tgluon.Trainer(params, "sgd", compression_params={"type": "2bit"})
    tr_dist = tgluon.Trainer(params, "sgd", kvstore="dist_sync")
    with cpu():
        tr_dist._init_kvstore()
    assert tr_dist._kvstore is not None and tr_dist._update_on_kvstore
    # the prefetcher's warm pull takes the store (run over two ranks in
    # tests/test_torch_ranks2.py)
    pf = tmx.gluon.data.DevicePrefetcher([], kvstore=kv, warm_pull={})
    assert pf._kvstore is kv


def test_kvstore_matches_jax():
    """init / push (a list sums) / pull / pushpull, and set_optimizer
    (updates in the store), against the JAX package's 'local' store."""
    rng = np.random.RandomState(3)
    init = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(3)]
    outs = []
    for pkg, nd in ((jmx, jnd), (tmx, tnd)):
        with cpu():
            kv = pkg.kv.create("local")
            assert kv.type == "local" and kv.rank == 0 and \
                kv.num_workers == 1
            kv.init(0, nd.array(init))
            kv.push(0, [nd.array(g) for g in grads])
            o1 = nd.zeros((4, 5))
            kv.pull(0, out=o1)
            o2 = nd.zeros((4, 5))
            kv.pushpull(0, nd.array(grads[0]), out=o2)
            # read now: the JAX store's update donates the pulled buffers
            o1, o2 = o1.asnumpy(), o2.asnumpy()
            kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1,
                                                  momentum=0.9))
            kv.push(0, nd.array(grads[1]))
            kv.push(0, nd.array(grads[2]))
            o3 = nd.zeros((4, 5))
            kv.pull(0, out=o3)
            with pytest.raises(pkg.base.MXNetError):
                kv.init(0, nd.array(init))
        outs.append([o1, o2, o3.asnumpy()])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_gluon_utils_match_jax():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    arrays = [rng.standard_normal(s).astype(np.float32) * 3
              for s in ((3, 4), (5,))]
    res = []
    for pkg, nd in ((jmx, jnd), (tmx, tnd)):
        with cpu():
            parts = pkg.gluon.utils.split_data(nd.array(x), 3)
            uneven = pkg.gluon.utils.split_data(nd.array(x), 4,
                                                even_split=False)
            cols = pkg.gluon.utils.split_data(nd.array(x), 2, batch_axis=1)
            loaded = pkg.gluon.utils.split_and_load(x, [pkg.cpu()])
            arrs = [nd.array(a) for a in arrays]
            norm = pkg.gluon.utils.clip_global_norm(arrs, 1.0)
            with pytest.raises(ValueError, match="evenly split"):
                pkg.gluon.utils.split_data(nd.array(x), 4)
        res.append(([p.asnumpy() for p in parts + uneven + cols + loaded],
                    norm, [a.asnumpy() for a in arrs]))
    (jp, jn, ja), (tp, tn, ta) = res
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    assert tn == pytest.approx(jn, rel=RTOL)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_check_sha1(tmp_path):
    f = tmp_path / "blob"
    f.write_bytes(b"mxnet")
    import hashlib

    digest = hashlib.sha1(b"mxnet").hexdigest()
    assert tmx.gluon.utils.check_sha1(str(f), digest)
    assert not tmx.gluon.utils.check_sha1(str(f), "0" * 40)


def test_loss_scaler_matches_jax():
    """The same overflow pattern moves both packages' scales alike
    (halving, tolerance, growth after the window, the cap)."""
    pattern = [False, True, False, False, False, True, True] + [False] * 9
    for kw in ({"init_scale": 1024.0, "scale_window": 3},
               {"init_scale": 2.0 ** 16, "scale_window": 2,
                "tolerance": 0.5}):
        j, t = jmx.amp.DynamicLossScaler(**kw), \
            tmx.amp.DynamicLossScaler(**kw)
        got = [t.update_scale(o) for o in pattern]
        want = [j.update_scale(o) for o in pattern]
        assert got == want
    with cpu():
        grads = [tnd.array(np.ones(3, np.float32)),
                 tnd.array(np.array([1.0, np.inf, 0.0], np.float32))]
        assert tmx.amp.DynamicLossScaler().has_overflow(grads)
        assert not tmx.amp.DynamicLossScaler().has_overflow(grads[:1])


def test_amp_init_and_scale_loss():
    params = _adam_params(n=1)
    tr = tgluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    tmx.amp.init_trainer(tr)
    assert tr.optimizer.multi_precision
    loss = torch.ones(2)
    try:
        tmx.amp.init("float16")
        with tmx.amp.scale_loss(loss, tr) as scaled:
            assert torch.equal(scaled, loss * 2.0 ** 16)
        assert tr._scale == 2.0 ** -16
        tmx.amp.init("bfloat16")
        with tmx.amp.scale_loss(loss, tr) as scaled:
            assert scaled is loss
    finally:
        tmx.amp.init("bfloat16")
    with pytest.raises(ValueError):
        tmx.amp.init("float64")


def test_numerics_health_and_guard(env):
    """The health pair against the JAX package's, the one counted readback
    of a StepGuard, and the env readers."""
    rng = np.random.RandomState(6)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    import jax.numpy as jjnp

    want = np.asarray(jmx.numerics.grad_health([jjnp.asarray(a)
                                                for a in arrs]))
    got = tmx.numerics.grad_health([torch.from_numpy(a) for a in arrs])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    bad = tmx.numerics.grad_health([torch.tensor([1.0, float("nan")])])
    tmx.numerics.reset_readback_count()
    guard = tmx.numerics.StepGuard(bad)
    assert guard.peek() is None
    assert not guard.healthy and not guard.healthy
    assert tmx.numerics.readback_count() == 1
    assert tmx.numerics.StepGuard(got).grad_norm == pytest.approx(
        float(np.sqrt(want[1])), rel=RTOL)
    env(MXTPU_CLIP_GLOBAL_NORM="2.5", MXTPU_GRAD_GUARD="off",
        MXTPU_MAX_BAD_STEPS="3")
    assert tmx.numerics.clip_global_norm_env() == 2.5
    assert not tmx.numerics.grad_guard_enabled()
    assert tmx.numerics.max_bad_steps() == 3
    both = tmx.numerics.combine_health([got, bad])
    assert both[0] == 0 and torch.isnan(both[1])


def test_divergence_monitor_raises_after_a_bad_streak(tmp_path):
    mon = tmx.numerics.DivergenceMonitor(max_bad_steps=3)
    for step in range(5):
        mon.observe(step=step, loss=1.0, grad_norm=1.0)
    mon.observe(step=5, grad_norm=100.0)         # explodes: bad
    mon.observe(step=6, healthy=False, batch_indices=[(0, 6)])
    with pytest.raises(tmx.numerics.DivergenceError) as e:
        mon.observe(step=7, loss=float("nan"), batch_indices=[(0, 7)])
    assert e.value.bad_steps == 3 and e.value.batch_indices == [(0, 6),
                                                               (0, 7)]
    # a checkpointer with nothing to roll back to: the streak still
    # raises, naming the window
    ck = tmx.resilience.LocalCheckpointer(str(tmp_path))
    mon = tmx.numerics.DivergenceMonitor(checkpointer=ck,
                                         set_state=lambda s: None,
                                         max_bad_steps=1)
    with pytest.raises(tmx.numerics.DivergenceError) as e:
        mon.observe(step=0, healthy=False, batch_indices=[(1, 2)])
    assert e.value.batch_indices == [(1, 2)] and mon.recoveries == 0


def test_public_names_of_ported_modules(tmp_path, monkeypatch):
    """``gluon.utils.download`` (``file://`` URLs and files already there,
    no network) and ``shape_is_known``, ``engine.is_naive`` and
    ``remat.env_policy``, each against the JAX package's."""
    from mxnet_tpu import engine as jengine
    from mxnet_tpu import remat as jremat
    from mxnet_tpu.gluon import utils as jutils
    from mxnet_tpu_torch import engine as tengine
    from mxnet_tpu_torch import remat as tremat
    from mxnet_tpu_torch.gluon import utils as tutils

    src = tmp_path / "w.params"
    src.write_bytes(b"weights")
    sha = __import__("hashlib").sha1(b"weights").hexdigest()
    for utils, sub in ((tutils, "t"), (jutils, "j")):
        d = tmp_path / sub
        d.mkdir()
        got = utils.download(f"file://{src}", path=str(d))
        assert got == str(d / "w.params") and (d / "w.params").read_bytes() \
            == b"weights"
        assert utils.download("https://example.invalid/w.params",
                              path=str(d), sha1_hash=sha) == got
        with pytest.raises(Exception, match="network"):
            utils.download("https://example.invalid/x.params", path=str(d))
    for shape in (None, (), (2, 3), (2, 0), (0,), [4, 1]):
        assert tutils.shape_is_known(shape) == jutils.shape_is_known(shape)
    for name in ("NaiveEngine", "ThreadedEnginePerDevice", "naiveengine"):
        tengine.set_engine_type(name)
        jengine.set_engine_type(name)
        assert tengine.is_naive() == jengine.is_naive()
    tengine.set_engine_type("ThreadedEnginePerDevice")
    jengine.set_engine_type("ThreadedEnginePerDevice")
    for value in (None, "", "none", "all", "dots", "save_every_k:2"):
        if value is None:
            monkeypatch.delenv("MXTPU_REMAT", raising=False)
        else:
            monkeypatch.setenv("MXTPU_REMAT", value)
        assert tremat.env_policy() == jremat.env_policy(), value
    # the deploy and bindings modules: every function and class the JAX
    # module (or package) defines has a counterpart of the same name in
    # the port's
    import importlib

    for module in ("test_utils", "runtime", "storage", "c_api_impl",
                   "contrib", "contrib.quantization", "contrib.onnx",
                   "contrib.onnx.mx2onnx", "contrib.onnx.onnx2mx",
                   "ops.quantization"):
        jm = importlib.import_module(f"mxnet_tpu.{module}")
        tm = importlib.import_module(f"mxnet_tpu_torch.{module}")
        names = {n for n in dir(jm) if not n.startswith("_") and getattr(
            getattr(jm, n), "__module__", "").startswith(jm.__name__)}
        assert names or module == "contrib", module
        missing = sorted(n for n in names if not hasattr(tm, n))
        assert not missing, (module, missing)
