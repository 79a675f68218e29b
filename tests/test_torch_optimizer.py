"""The port's optimizers against the JAX package's, on the CPU.

- every registered optimizer (all 18) runs three updates through its
  ``Updater`` in both packages from the same numpy weights and gradients:
  weights and states within rtol 2e-4 / atol 2e-5 (SGLD's noise comes from
  each package's own generator: its update is held to the rule with the
  port's noise replayed, and the JAX run's spread around the noise-free
  trajectory to the port's);
- multi-precision: float16 keeps an f32 master in both packages; bfloat16
  keeps one in the port only (the JAX package updates bf16 directly), so
  there the port's master is held to the JAX f32 run from the same
  rounded inputs;
- the registered ``mx.nd.*_update`` ops' in-place contract;
- ``GroupedUpdater`` bitwise against the port's per-parameter ``Updater``
  (``test_grouped_optimizer.py``'s configurations), its dispatch counts
  and its fallbacks.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import Parameter, Trainer
from mxnet_tpu_torch.optimizer import grouped

RTOL, ATOL = 2e-4, 2e-5
SHAPES = [(5, 7), (3,), (2, 3, 4), (1,), (8, 2), (4, 4)]
STEPS = 3

# test_grouped_optimizer.py's configurations, plus the optimizers that
# run inline (no grouped plan)
CONFIGS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "clip_gradient": 0.5}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3, "clip_gradient": 0.3}),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 1e-3}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 2.0}),
    ("adagrad", {"learning_rate": 0.1}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 1e-5}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("lamb", {"learning_rate": 1e-3}),
    ("lamb", {"learning_rate": 1e-3, "bias_correction": False,
              "lower_bound": 0.1, "upper_bound": 10.0}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9, "batch_scale": 4,
               "warmup_epochs": 1, "updates_per_epoch": 2}),
    ("ftml", {"learning_rate": 1e-3}),
]
INLINE = [
    ("adamax", {"learning_rate": 2e-3, "wd": 1e-3}),
    ("nadam", {"learning_rate": 1e-3}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {"learning_rate": 0.1}),
]


def _arrays(seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    ws = [rng.standard_normal(s).astype(dtype) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(dtype) for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _leaves(s)]
    return [np.asarray(state.asnumpy(), np.float64)]


def _run_jax(name, kw, ws, gs, dtype="float32"):
    upd = jmx.optimizer.get_updater(jmx.optimizer.create(name, **kw))
    weights = [jnd.array(w, dtype=dtype) for w in ws]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            upd(i, jnd.array(g, dtype=dtype), w)
    return ([np.asarray(w.asnumpy(), np.float64) for w in weights],
            {i: _leaves(s) for i, s in upd.states.items()})


def _run_port(name, kw, ws, gs, dtype="float32"):
    with cpu():
        upd = tmx.optimizer.get_updater(tmx.optimizer.create(name, **kw))
        weights = [tnd.array(w, dtype=dtype) for w in ws]
        for step in gs:
            for i, (w, g) in enumerate(zip(weights, step)):
                upd(i, tnd.array(g, dtype=dtype), w)
    return ([np.asarray(w.asnumpy(), np.float64) for w in weights],
            {i: _leaves(s) for i, s in upd.states.items()})


def _close(got, want, what):
    gw, gs = got
    ww, ws = want
    for i, (a, b) in enumerate(zip(gw, ww)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} weight {i}")
    assert set(gs) == set(ws)
    for i in gs:
        assert len(gs[i]) == len(ws[i]), (what, i)
        for a, b in zip(gs[i], ws[i]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} state {i}")


def test_every_registered_optimizer_is_covered():
    names = {n for n, _ in CONFIGS + INLINE} | {"sgld"}
    assert names == set(tmx.optimizer.Optimizer.opt_registry)
    assert set(tmx.optimizer.Optimizer.opt_registry) == set(
        jmx.optimizer.Optimizer.opt_registry)
    assert len(names) == 18


@pytest.mark.parametrize("name,kw", CONFIGS + INLINE,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONFIGS + INLINE)])
def test_optimizer_matches_jax(name, kw):
    ws, gs = _arrays(1)
    _close(_run_port(name, kw, ws, gs), _run_jax(name, kw, ws, gs), name)


def test_sgld_rule_and_noise():
    """SGLD: the port's update is w - lr/2 (g + wd w) + N(0, lr) with its
    noise drawn from the scope's generator; the JAX run spreads around the
    noise-free trajectory as the port's does."""
    lr, wd = 1e-2, 1e-3
    rng = np.random.RandomState(2)
    w0 = rng.standard_normal((200, 50)).astype(np.float32)
    gs = [rng.standard_normal((200, 50)).astype(np.float32)
          for _ in range(STEPS)]
    with cpu():
        upd = tmx.optimizer.get_updater(
            tmx.optimizer.create("sgld", learning_rate=lr, wd=wd))
        w = tnd.array(w0)
        with tmx.random.generator_scope(torch.Generator().manual_seed(5)):
            for g in gs:
                upd(0, tnd.array(g), w)
    replay = torch.Generator().manual_seed(5)
    ref, det = torch.from_numpy(w0), torch.from_numpy(w0)
    for g in gs:
        g = torch.from_numpy(g)
        ref = ref - lr / 2 * (g + wd * ref) + torch.randn(
            ref.shape, generator=replay) * np.sqrt(lr)
        det = det - lr / 2 * (g + wd * det)
    np.testing.assert_allclose(w.asnumpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    jw = jnd.array(w0)
    jupd = jmx.optimizer.get_updater(
        jmx.optimizer.create("sgld", learning_rate=lr, wd=wd))
    for g in gs:
        jupd(0, jnd.array(g), jw)
    spread_port = float(np.std(w.asnumpy() - det.numpy()))
    spread_jax = float(np.std(jw.asnumpy() - det.numpy()))
    want = np.sqrt(STEPS * lr)
    assert abs(spread_port / want - 1) < 0.05, spread_port
    assert abs(spread_jax / spread_port - 1) < 0.05, (spread_jax,
                                                      spread_port)


MP_CONFIGS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
              ("adam", {"learning_rate": 1e-3})]


@pytest.mark.parametrize("name,kw", MP_CONFIGS, ids=["sgd", "adam"])
def test_multi_precision_float16_matches_jax(name, kw):
    """f16 weights on f32 masters in both packages: the masters and states
    agree, and each package's f16 weight is its master rounded."""
    ws, gs = _arrays(3, "float16")
    kw = dict(kw, multi_precision=True)
    jw, js = _run_jax(name, kw, ws, gs, "float16")
    tw, ts = _run_port(name, kw, ws, gs, "float16")
    for i in range(len(SHAPES)):
        jmaster, tmaster = js[i][0], ts[i][0]
        np.testing.assert_allclose(tmaster, jmaster, rtol=RTOL, atol=ATOL)
        for a, b in zip(ts[i][1:], js[i][1:]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            tw[i], tmaster.astype(np.float32).astype(np.float16))
        np.testing.assert_array_equal(
            jw[i], jmaster.astype(np.float32).astype(np.float16))


@pytest.mark.parametrize("name,kw", MP_CONFIGS, ids=["sgd", "adam"])
def test_multi_precision_bfloat16_keeps_an_f32_master(name, kw):
    """bf16 weights on f32 masters (the port's extension: the JAX package
    updates bf16 in place): the port's master follows the JAX f32 run from
    the same bf16-rounded weights and gradients, and its bf16 weight is
    the master rounded."""
    def rounded(a):
        return torch.from_numpy(a).bfloat16().float().numpy()

    ws, gs = _arrays(4)
    ws, gs = [rounded(w) for w in ws], [[rounded(g) for g in s] for s in gs]
    jw, js = _run_jax(name, kw, ws, gs)
    with cpu():
        upd = tmx.optimizer.get_updater(tmx.optimizer.create(
            name, multi_precision=True, **kw))
        weights = [tnd.array(w, dtype="bfloat16") for w in ws]
        for step in gs:
            for i, (w, g) in enumerate(zip(weights, step)):
                upd(i, tnd.array(g, dtype="bfloat16"), w)
    for i, w in enumerate(weights):
        master, *states = upd.states[i][0], *_leaves(upd.states[i][1])
        assert master._data.dtype == torch.float32
        np.testing.assert_allclose(master.asnumpy(), jw[i], rtol=RTOL,
                                   atol=ATOL)
        for a, b in zip(states, js[i]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert torch.equal(w._data, master._data.bfloat16())


@pytest.mark.parametrize("op,n_states,kw", [
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam_update", 2, {"lr": 0.01}),
    ("ftml_update", 3, {"lr": 0.01, "t": 2}),
    ("mp_sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9}),
])
def test_update_ops_write_states_and_out(op, n_states, kw):
    """mx.nd.<op>(weight, grad, *states[, weight32], out=weight): the states
    change in place and ``out`` takes the new weight, as in the JAX
    package, with the same values."""
    rng = np.random.RandomState(5)
    w, g = rng.standard_normal((2, 6)).astype(np.float32)
    states = [np.abs(rng.standard_normal(6)).astype(np.float32)
              for _ in range(n_states)]
    if op.startswith("mp_"):
        states.append(w.copy())
    results = []
    for nd, scope in ((jnd, None), (tnd, cpu())):
        if scope is not None:
            scope.__enter__()
        try:
            wa = nd.array(w)
            sa = [nd.array(s) for s in states]
            ret = getattr(nd, op)(wa, nd.array(g), *sa, out=wa, **kw)
            assert ret is wa
            results.append([wa.asnumpy()] + [s.asnumpy() for s in sa])
        finally:
            if scope is not None:
                scope.__exit__(None, None, None)
    for a, b in zip(*reversed(results)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert not np.allclose(results[1][1], states[0])    # a state moved


# -- GroupedUpdater against the per-parameter Updater, bitwise ----------------

@pytest.fixture
def fused_env():
    saved = os.environ.get("MXTPU_FUSED_STEP")
    yield
    if saved is None:
        os.environ.pop("MXTPU_FUSED_STEP", None)
    else:
        os.environ["MXTPU_FUSED_STEP"] = saved


def _params(dtype="float32", seed=0, lr_mults=None, wd_mults=None):
    rng = np.random.RandomState(seed)
    params = []
    for k, shape in enumerate(SHAPES):
        p = Parameter(f"p{k}_weight", shape=shape, dtype=dtype)
        p.initialize(ctx=cpu())
        p.set_data(torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)))
        if lr_mults:
            p.lr_mult = lr_mults[k % len(lr_mults)]
        if wd_mults:
            p.wd_mult = wd_mults[k % len(wd_mults)]
        params.append(p)
    return params


def _set_grads(params, rng):
    for p in params:
        g = p.grad()
        g._data = torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)).to(g._data.dtype)
        p.data()._fresh_grad = True


def _trainer_run(name, kw, fused, dtype="float32", steps=5, seed=0,
                 **mults):
    """``steps`` Trainer.step calls with deterministic gradients; returns
    the weights and states as host tensors."""
    os.environ["MXTPU_FUSED_STEP"] = "1" if fused else "0"
    params = _params(dtype, seed, **mults)
    trainer = Trainer(params, name, dict(kw), kvstore=None)
    rng = np.random.RandomState(seed + 1)
    for _ in range(steps):
        _set_grads(params, rng)
        trainer.step(2)
    states = [t._data.clone() for i in sorted(trainer._updaters[0].states)
              for t in _flat(trainer._updaters[0].states[i])]
    return [p.data()._data.clone() for p in params], states


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _equal(a, b):
    assert len(a[0]) == len(b[0]) and len(a[1]) == len(b[1])
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype
        assert torch.equal(x, y), (x - y).abs().max()


@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONFIGS)])
def test_grouped_bitwise_equals_updater(fused_env, name, kw):
    _equal(_trainer_run(name, kw, True), _trainer_run(name, kw, False))


@pytest.mark.parametrize("case", ["float16-mp", "bfloat16-mp", "float16",
                                  "scheduler", "mults"])
def test_grouped_bitwise_equals_updater_cases(fused_env, case):
    """Multi-precision (f32 masters), plain f16, an LR schedule, and lr/wd
    multipliers that differ by parameter (non-uniform columns)."""
    def run(fused):
        kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
        extra = {}
        dtype = "float32"
        if case.endswith("-mp"):
            dtype, kw["multi_precision"] = case[:-3], True
        elif case == "float16":
            dtype = "float16"
        elif case == "scheduler":
            kw["lr_scheduler"] = tmx.optimizer.FactorScheduler(step=2,
                                                               factor=0.5)
        else:
            extra = dict(lr_mults=[1.0, 0.5, 2.0], wd_mults=[1.0, 0.0])
        return _trainer_run("sgd", kw, fused, dtype, **extra)

    _equal(run(True), run(False))


def _step_once(params, trainer, seed=0):
    _set_grads(params, np.random.RandomState(seed))
    trainer.step(1)


@pytest.mark.parametrize("case,want", [
    ("adam", 1), ("lars", 2), ("mixed", 2), ("nadam", 0), ("subclass", 0),
    ("legacy", 0)])
def test_grouped_dispatch_counts(fused_env, case, want):
    """One dispatch per (rule, hyper-params, dtype) group per step: Adam
    over one f32 group; LARS's 1-D and n-D rules; f32 and f16 groups; none
    for an optimizer without a plan, a user subclass, or under
    MXTPU_FUSED_STEP=0 (the legacy loop still updates)."""
    os.environ["MXTPU_FUSED_STEP"] = "0" if case == "legacy" else "1"
    params = _params()
    if case == "mixed":
        params += [Parameter(f"h{i}_weight", shape=(3, 2), dtype="float16")
                   for i in range(2)]
        for p in params[-2:]:
            p.initialize(ctx=cpu())
    opt = {"adam": "adam", "lars": "lars", "mixed": "sgd", "nadam": "nadam",
           "legacy": "adam"}.get(case)
    if case == "subclass":
        class MySGD(tmx.optimizer.SGD):
            pass
        opt = MySGD(learning_rate=0.1)
    trainer = Trainer(params, opt, None if case == "subclass" else
                      {"learning_rate": 0.1}, kvstore=None)
    before = [p.data()._data.clone() for p in params]
    grouped.reset_dispatch_count()
    for step in range(2):
        _step_once(params, trainer, seed=step)
    assert grouped.dispatch_count() == 2 * want
    assert all(not torch.equal(b, p.data()._data)
               for b, p in zip(before, params))


def test_fused_then_legacy_continues_the_same_states(fused_env):
    """Switching MXTPU_FUSED_STEP mid-run keeps stepping the same states,
    to the bit."""
    finals = []
    for flip_at in (None, 2):
        os.environ["MXTPU_FUSED_STEP"] = "0" if flip_at is None else "1"
        params = _params()
        trainer = Trainer(params, "adam", {"learning_rate": 1e-3},
                          kvstore=None)
        rng = np.random.RandomState(1)
        for step in range(4):
            if step == flip_at:
                os.environ["MXTPU_FUSED_STEP"] = "0"
            _set_grads(params, rng)
            trainer.step(2)
        finals.append([p.data()._data.clone() for p in params])
    for a, b in zip(*finals):
        assert torch.equal(a, b)
