"""The port's training path against the JAX package's, on the CPU, with
the same numpy inputs and weights through both: the LM loss, the seven
pure optimizers, the lr schedulers, and ``ShardedTrainer`` on ``gpt_tiny``
(dense and flash trunks) over five steps; plus the port's own dropout,
trainer and serving-export behaviour."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, parallel as jparallel, serving as jserving
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.optimizer import lr_scheduler as jsched
from mxnet_tpu.parallel import trainer as jtrainer
from mxnet_tpu_torch import convert, random
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import flash_attention as tflash
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched
from mxnet_tpu_torch.parallel import ShardedTrainer, trainer as ttrainer
from mxnet_tpu_torch.serving import ServingEngine, state_for_serving

RTOL, ATOL = 2e-4, 2e-5


def _logits_labels(seed, B=3, T=9, V=17):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, V).astype(np.float32) * 3
    labels = rng.randint(0, V, (B, T))
    labels[rng.rand(B, T) < 0.3] = -1          # ignored positions
    return logits, labels


def test_lm_loss_matches_jax():
    logits, labels = _logits_labels(0)
    want = float(jgpt._lm_loss_pure(jnp.asarray(logits), jnp.asarray(labels)))
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    got = tgpt.GPTLMLoss()(tl, ty)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    # float labels (the JAX examples feed float NDArrays) and bf16 logits
    np.testing.assert_allclose(float(tgpt.GPTLMLoss()(tl, ty.float())), want,
                               rtol=RTOL, atol=ATOL)


def test_masked_token_ce_matches_jax():
    logits, labels = _logits_labels(1)
    want = float(jbert.masked_token_ce(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = tbert.masked_token_ce(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    # no valid label: the denominator is clamped to 1, the loss is 0
    none = -np.ones_like(labels)
    assert float(tbert.masked_token_ce(torch.from_numpy(logits),
                                       torch.from_numpy(none))) == 0.0 == \
        float(jbert.masked_token_ce(jnp.asarray(logits), jnp.asarray(none)))


# (name, optimizer kwargs): all seven update rules, with weight decay,
# gradient clipping, and per-parameter wd/lr multipliers below
OPTIMIZERS = [
    ("sgd", {"wd": 1e-2, "clip_gradient": 0.5}),
    ("sgd", {"momentum": 0.9, "wd": 1e-2, "clip_gradient": 0.5}),
    ("nag", {"momentum": 0.9, "wd": 1e-2}),
    ("adam", {"wd": 1e-2, "clip_gradient": 0.5}),
    ("adamw", {"wd": 1e-2, "clip_gradient": 0.5}),
    ("lamb", {"wd": 1e-2, "lower_bound": 0.1, "upper_bound": 10.0}),
    ("rmsprop", {"wd": 1e-2, "clip_weights": 0.8}),
    ("rmsprop", {"centered": True, "wd": 1e-2, "clip_gradient": 0.5}),
    ("adagrad", {"wd": 1e-2}),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_pure_optimizer_matches_jax(name, kw):
    """Three updates of _PureOptimizer.apply on numpy weights and
    gradients, states carried, against the JAX one; f32 elementwise math
    in both, so they agree to rounding."""
    rng = np.random.RandomState(2)
    shapes = [(4, 5), (7,), (3, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    wd_mults, lr_mults = [1.0, 0.0, 0.5], [1.0, 2.0, 0.5]
    jopt = jtrainer._PureOptimizer(name, lr=0.05, **kw)
    topt = ttrainer._PureOptimizer(name, lr=0.05, **kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for t in (1, 2, 3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        jp, js = jopt.apply(jp, [jnp.asarray(g) for g in grads], js, 0.05,
                            t, wd_mults, lr_mults, 1.0)
        tp, ts = topt.apply(tp, [torch.from_numpy(g) for g in grads], ts,
                            0.05, t, wd_mults, lr_mults, 1.0)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for sa, sb in zip(ts, js):
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_pure_optimizer_keeps_the_parameter_dtype():
    opt = ttrainer._PureOptimizer("adamw", lr=0.1)
    p = [torch.ones((3, 3), dtype=torch.bfloat16)]
    s = opt.init_state(p)
    new_p, new_s = opt.apply(p, [torch.ones_like(p[0])], s, 0.1, 1, [1.0],
                             [1.0], 1.0)
    assert new_p[0].dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in new_s[0])
    assert torch.equal(new_p[0], torch.full((3, 3), 0.9).bfloat16())


@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=3, factor=0.5, base_lr=1.0,
                                warmup_steps=2, warmup_begin_lr=0.1),
    lambda m: m.MultiFactorScheduler(step=[4, 7], factor=0.3, base_lr=0.5),
    lambda m: m.PolyScheduler(max_update=12, base_lr=0.2, pwr=2,
                              final_lr=0.01, warmup_steps=3,
                              warmup_mode="constant"),
    lambda m: m.CosineScheduler(max_update=10, base_lr=0.3, final_lr=0.05,
                                warmup_steps=2),
])
def test_lr_schedulers_match_jax(make):
    js, ts = make(jsched), make(tsched)
    for n in range(15):
        assert ts(n) == pytest.approx(js(n), rel=1e-12, abs=1e-15), n


def _jax_gpt(impl, seed=0, dropout=0.0):
    """gpt_tiny with Xavier weights and random (not zero/one) biases and
    LayerNorm parameters, so every parameter trains."""
    mx.random.seed(seed)
    net = jgpt.gpt_tiny(scan_layers=True, attention_impl=impl,
                        dropout=dropout)
    net.initialize(init=mx.init.Xavier())
    net(nd.array(np.zeros((1, 4), np.float32)))
    rng = np.random.RandomState(seed + 1)
    for name, p in net.collect_params().items():
        if name.endswith(("bias", "beta", "gamma")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(nd.array(
                base + 0.1 * rng.randn(*p.shape).astype(np.float32)))
    return net


def _port_of(net, impl, dropout=0.0):
    model = tgpt.gpt_tiny(attention_impl=impl, dropout=dropout,
                          scan_layers=True, device=cpu())
    convert.load_state(model, jserving.state_for_serving(net))
    return model


def _corpus(B=4, T=32, vocab=128, seed=0):
    """examples/gpt_pretrain_sharded.py's permutation corpus:
    tok_{t+1} = perm[tok_t]."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(vocab)
    seqs = [rng.randint(0, vocab, (B,))]
    for _ in range(T - 1):
        seqs.append(perm[seqs[-1]])
    return np.stack(seqs, axis=1).astype(np.int32)


def _by_suffix(state):
    return convert.match_state(state, "test")


# Final parameters, at rtol 2e-3 / atol 2e-4 (the JAX package's gradient
# tolerance) for every optimizer.  For the adam family that is a claim
# about these inputs, not a bound: an update moves a weight by about
# lr * m / sqrt(v), and where a gradient is near zero that ratio divides
# two rounding-level numbers whose sign and size the summation order
# decides, so such a weight could land up to lr per step from the other
# framework's.  Random biases and LayerNorm parameters keep every gradient
# here far from zero: the largest difference after five adamw steps is
# 2.5e-6 (dense with grad_accum=2 and flash alike).  The loss trajectory
# is held at rtol 2e-4 in every case.
LR = {"sgd": 0.1, "adamw": 1e-3}
OPT_KW = {"sgd": {"momentum": 0.9, "wd": 1e-3}, "adamw": {"wd": 1e-2}}


@pytest.mark.parametrize("impl,opt,accum", [
    ("dense", "sgd", 1),
    ("flash", "sgd", 1),
    ("dense", "adamw", 2),
    ("flash", "adamw", 1),
])
def test_sharded_trainer_matches_jax(impl, opt, accum):
    steps = 5
    net = _jax_gpt(impl)
    model = _port_of(net, impl)
    ids = _corpus()
    params = dict(OPT_KW[opt], learning_rate=LR[opt])
    jtr = jparallel.ShardedTrainer(net, jgpt.GPTLMLoss(), opt, params,
                                   mesh=jparallel.data_parallel_mesh(1),
                                   grad_accum=accum)
    ttr = ShardedTrainer(model, tgpt.GPTLMLoss(), opt, params,
                         grad_accum=accum)
    fwd = tflash.flash_attention_fwd.launches
    want, got = [], []
    for _ in range(steps):
        want.append(float(np.asarray(jtr.step(
            nd.array(ids.astype(np.float32)),
            nd.array(ids.astype(np.float32)))._data)))
        got.append(float(ttr.step(ids, ids)))
    assert tflash.flash_attention_fwd.launches == fwd    # CPU: no kernel
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
    assert not model.training              # the step restores eval mode
    jtr.sync_params()
    ref = _by_suffix(jserving.state_for_serving(net))
    mine = _by_suffix(state_for_serving(model))
    assert set(ref) == set(mine)
    for name in ref:
        np.testing.assert_allclose(mine[name], ref[name], rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_dropout_trains_from_the_step_generator():
    """Same package seed -> same loss; another seed -> another loss; eval
    mode is deterministic; flash with attention dropout still raises."""
    net = _jax_gpt("dense")
    ids = _corpus(B=2, T=16)

    def first_loss(seed):
        model = _port_of(net, "dense", dropout=0.2)
        random.seed(seed)
        return float(ShardedTrainer(model, tgpt.GPTLMLoss(), "sgd",
                                    {"learning_rate": 0.1}).step(ids, ids))

    a, b, c = first_loss(5), first_loss(5), first_loss(6)
    assert a == b and a != c
    model = _port_of(net, "dense", dropout=0.2)
    x = torch.from_numpy(ids)
    assert torch.equal(model(x), model(x))
    no_drop = float(tgpt.GPTLMLoss()(model(x), x).detach())
    assert no_drop != a
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(NotImplementedError, match="dropout"):
        tatt.scaled_dot_product_attention(q, q, q, impl="flash",
                                          dropout_p=0.1)


def test_trainer_surface():
    """learning_rate and schedulers, set_learning_rate, the refusals of
    what is not ported, remat (whose step equals the plain one's), and a
    bf16 model keeping its dtype."""
    model = tgpt.gpt_tiny(device=cpu())
    sched = tsched.FactorScheduler(step=1, factor=0.5, base_lr=0.2)
    tr = ShardedTrainer(model, tgpt.GPTLMLoss(), "sgd",
                        {"learning_rate": 0.2, "lr_scheduler": sched})
    ids = _corpus(B=2, T=8)
    tr.step(ids, ids)
    tr.step(ids, ids)
    assert tr.learning_rate == pytest.approx(0.1)
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05
    tr.sync_params()
    for kwargs in ({"mesh": object()}, {"rules": object()}, {"mode": "tp"}):
        with pytest.raises(NotImplementedError):
            ShardedTrainer(model, tgpt.GPTLMLoss(), **kwargs)
    drop = tgpt.gpt_tiny(device=cpu(), dropout=0.1)
    runs = []
    for remat in (None, "full", "dots"):
        m = tgpt.gpt_tiny(device=cpu(), dropout=0.1)
        m.load_state_dict(drop.state_dict())
        random.seed(3)
        rtr = ShardedTrainer(m, tgpt.GPTLMLoss(), "adamw",
                             {"learning_rate": 1e-2}, remat=remat)
        runs.append(([float(rtr.step(ids, ids)) for _ in range(2)],
                     [p.detach().clone() for p in m.parameters()]))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][1]))
    with pytest.raises(ValueError, match="not divisible"):
        ShardedTrainer(model, tgpt.GPTLMLoss(), grad_accum=3).step(ids, ids)
    with pytest.raises(NotImplementedError):
        tr.state_dict()
    bf = tgpt.gpt_tiny(device=cpu(), attention_impl="flash").cast(
        "bfloat16")
    btr = ShardedTrainer(bf, tgpt.GPTLMLoss(), "adamw",
                         {"learning_rate": 1e-3})
    losses = [float(btr.step(ids, ids)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_trained_model_goes_to_the_engine():
    """state_for_serving writes what load_state and the engine's
    reload_from_state read: a model trained by the port serves the same
    greedy tokens as generate() on it."""
    net = _jax_gpt("flash")
    model = _port_of(net, "flash")
    ids = _corpus(B=2, T=16)
    tr = ShardedTrainer(model, tgpt.GPTLMLoss(), "adamw",
                        {"learning_rate": 1e-2})
    for _ in range(3):
        tr.step(ids, ids)
    state = state_for_serving(model)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in state.values())
    fresh = tgpt.gpt_tiny(device=cpu(), scan_layers=True)
    convert.load_state(fresh, state)
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    eng = ServingEngine(tgpt.gpt_tiny(device=cpu()), batch_buckets=(2,))
    eng.reload_from_state(state)
    prompts = ids[:, :6]
    got, _ = eng.serve_group(list(prompts), 5)
    ref = tgpt.generate(model, prompts, max_new_tokens=5)
    np.testing.assert_array_equal(np.stack(got), ref.asnumpy()[:, 6:])
