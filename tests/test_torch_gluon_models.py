"""The zoo's transformers as Gluon blocks, against the JAX package's, on the
CPU: ``collect_params()`` names and shapes of BERT, GPT and ViT in both
trunk layouts, forward, loss and gradients with the JAX weights carried
across by name (``convert.load_gluon_params``), the layout conversion,
LoRA (``apply_lora``/``freeze_for_lora``/``merge`` and the trunk's
adapters), remat (the policy registry, ``hybridize(remat=)``, remat
inside the captured step, dropout included), the captured step's
invalidation on LoRA changes, and three ``gluon.Trainer`` steps of
``bert_tiny``.  Outputs at rtol 2e-4 / atol 2e-5, gradients and trained
weights at 2e-3 / 2e-4."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd, gluon as jgluon, nd
from mxnet_tpu import remat as jremat
from mxnet_tpu.gluon.contrib import lora as jlora
from mxnet_tpu.gluon.model_zoo import bert as jbert, gpt as jgpt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd, convert, gluon, random, remat
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import captured
from mxnet_tpu_torch.gluon.contrib import lora
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert, gpt as tgpt
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
MODELS = [("bert", True), ("bert", False), ("gpt", True), ("gpt", False),
          ("vit", True), ("vit", False)]


def _jax_model(kind, scan, seed=0):
    """The JAX model with Xavier weights and random biases and LayerNorm
    parameters, shapes resolved by one forward; hybridized, so its
    forward and backward are one compiled program each, not one an
    operator."""
    mx.random.seed(seed)
    if kind == "bert":
        net = jbert.bert_tiny(scan_layers=scan, dropout=0.0)
    elif kind == "gpt":
        net = jgpt.gpt_tiny(scan_layers=scan)
    else:
        net = jvision.vit_tiny(scan_layers=scan)
    net.initialize(init=mx.init.Xavier())
    net.hybridize()
    net(nd.array(_inputs(kind)))
    rng = np.random.RandomState(seed + 1)
    for name, p in net.collect_params().items():
        if name.endswith(("bias", "beta", "gamma", "cls_token")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(nd.array(
                base + 0.1 * rng.randn(*p.shape).astype(np.float32)))
    return net


_SHARED = {}


def _shared_jax_model(kind, scan):
    """``_jax_model(kind, scan)`` built once for the tests that only read
    it (forward, gradients, names), so its compiled programs serve them
    all."""
    if (kind, scan) not in _SHARED:
        _SHARED[kind, scan] = _jax_model(kind, scan)
    return _SHARED[kind, scan]


def _port_model(kind, scan):
    if kind == "bert":
        return tbert.bert_tiny(scan_layers=scan, dropout=0.0, device=cpu())
    if kind == "gpt":
        return tgpt.gpt_tiny(scan_layers=scan, device=cpu())
    net = tvision.vit_tiny(scan_layers=scan)
    net.initialize(ctx=cpu())
    net(torch.from_numpy(_inputs(kind)))
    return net


def _inputs(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "vit":
        return rng.randn(2, 3, 32, 32).astype(np.float32)
    return rng.randint(0, 128, (2, 16)).astype(np.float32)


def _labels(kind, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "bert":
        mlm = rng.randint(0, 1024, (2, 16)).astype(np.float32)
        mlm[rng.rand(2, 16) < 0.7] = -1
        return mlm, rng.randint(0, 2, (2,)).astype(np.float32)
    if kind == "vit":
        return rng.randint(0, 10, (2,)).astype(np.float32)
    return None


def _shapes(net):
    return {n[len(net.prefix):]: tuple(p.shape)
            for n, p in net.collect_params().items()}


def _numpy(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


@pytest.mark.parametrize("kind,scan", MODELS)
def test_collect_params_names_match_jax(kind, scan):
    """Every parameter's Gluon name (less the top-level prefix) and shape,
    in creation order, and the block types the reference has."""
    net, model = _shared_jax_model(kind, scan), _port_model(kind, scan)
    assert list(_shapes(model).items()) == list(_shapes(net).items())
    assert isinstance(model, gluon.HybridBlock)
    trunk = tbert.ScanTransformerEncoder if scan else \
        tbert.TransformerEncoder
    assert isinstance(model.encoder, trunk)


def _jax_loss(kind, out, labels):
    if kind == "bert":
        return jbert.BERTPretrainLoss()(
            out, tuple(nd.array(a) for a in labels))
    if kind == "gpt":
        return jgpt.GPTLMLoss()(out, nd.array(_inputs(kind)))
    return jgluon.loss.SoftmaxCrossEntropyLoss()(out, nd.array(labels))


def _port_loss(kind, out, labels):
    if kind == "bert":
        return tbert.BERTPretrainLoss()(
            out, tuple(torch.from_numpy(a) for a in labels))
    if kind == "gpt":
        return tgpt.GPTLMLoss()(out, torch.from_numpy(_inputs(kind)))
    return gluon.loss.SoftmaxCrossEntropyLoss()(out,
                                                torch.from_numpy(labels))


@pytest.mark.parametrize("kind,scan", MODELS)
def test_forward_loss_and_gradients_match_jax(kind, scan):
    net, model = _shared_jax_model(kind, scan), _port_model(kind, scan)
    convert.load_gluon_params(model, _numpy(net))
    x, labels = _inputs(kind), _labels(kind)
    with jautograd.record():
        jout = net(nd.array(x))
        jloss = _jax_loss(kind, jout, labels)
    jloss.backward()
    with autograd.train_mode():
        out = model(torch.from_numpy(x))
    outs = out if isinstance(out, tuple) else (out,)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                   rtol=RTOL, atol=ATOL)
    loss = _port_loss(kind, out, labels)
    np.testing.assert_allclose(loss.detach().numpy(), jloss.asnumpy(),
                               rtol=RTOL, atol=ATOL)
    params = model.collect_params()
    grads = torch.autograd.grad(loss.sum(),
                                [p._value() for p in params.values()])
    want = net.collect_params()
    for (name, _p), g in zip(params.items(), grads):
        key = net.prefix + name[len(model.prefix):]
        np.testing.assert_allclose(g.numpy(), want[key].grad().asnumpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["bert", "gpt", "vit"])
def test_relayout_loads_either_layout(kind):
    """A per-layer JAX model's weights load into the port's scanned model
    (and the scanned one's into the per-layer port model) through
    ``convert.relayout``, with the same outputs; the round trip is the
    identity."""
    for scan in (True, False):
        net = _shared_jax_model(kind, scan)
        params = _numpy(net)
        back = convert.relayout(convert.relayout(params, not scan), scan)
        assert sorted(back) == sorted(params)
        assert all(np.array_equal(back[k], params[k]) for k in params)
        other = _port_model(kind, not scan)
        convert.load_gluon_params(other, convert.relayout(params, not scan))
        want = net(nd.array(_inputs(kind)))
        got = other(torch.from_numpy(_inputs(kind)))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                       rtol=RTOL, atol=ATOL)


def _dense_net(pkg, prefix, seed):
    """test_gluon.py:360's net: Dense(32, relu) -> Dense(8), in_units 12."""
    nn = pkg.gluon.nn if pkg is mx else gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu", in_units=12),
                nn.Dense(8, in_units=32))
    if pkg is mx:
        mx.random.seed(seed)
        net.initialize(init=mx.init.Xavier())
    else:
        net.initialize(ctx=cpu())
    return net


def test_apply_lora_trains_like_jax():
    """apply_lora on both packages' nets with the same weights and the
    same adapters: the adapted net starts equal to the base, five Adam
    steps train only the adapters, to the JAX weights, and merge() folds
    the update in without changing the outputs."""
    import mxnet_tpu_torch as tmx

    rng = np.random.RandomState(0)
    x, y = rng.randn(16, 12).astype(np.float32), \
        rng.randn(16, 8).astype(np.float32)
    jnet = _dense_net(mx, "lora_", 0)
    tnet = _dense_net(tmx, "lora_", 0)
    convert.load_gluon_params(tnet, _numpy(jnet))
    base = jnet(nd.array(x)).asnumpy()
    jw = jlora.apply_lora(jnet, rank=4, alpha=8, patterns=("dense",))
    tw = lora.apply_lora(tnet, rank=4, alpha=8, patterns=("dense",))
    assert len(tw) == len(jw) == 2 and tnet[0] is tw[0]
    assert sorted(_shapes(tnet).items()) == sorted(_shapes(jnet).items())
    for b in jw:                       # B non-zero: the adapters act
        b.lora_b.set_data(nd.array(0.05 * rng.randn(*b.lora_b.shape)
                                   .astype(np.float32)))
    convert.load_gluon_params(tnet, _numpy(jnet))
    assert {n: p.grad_req for n, p in tnet.collect_params().items()} == {
        n: p.grad_req for n, p in jnet.collect_params().items()}
    frozen = {n: p.data().asnumpy().copy()
              for n, p in tnet.collect_params().items()
              if p.grad_req == "null"}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 1e-2})
    ttr = gluon.Trainer(tnet.collect_params(), "adam",
                        {"learning_rate": 1e-2})
    jl2, tl2 = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
    with cpu():
        tx, ty = tmx.nd.array(x), tmx.nd.array(y)
    for _ in range(5):
        with jautograd.record():
            jl = jl2(jnet(nd.array(x)), nd.array(y))
        jl.backward()
        jtr.step(16)
        with autograd.record():
            tl = tl2(tnet(tx), ty)
        tl.backward()
        ttr.step(16)
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
    want = _numpy(jnet)
    for name, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), want[name],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        if name in frozen:
            np.testing.assert_array_equal(p.data().asnumpy(), frozen[name])
    assert not np.allclose(tnet(tx).asnumpy(), base, atol=1e-3)
    pred = tnet(tx).asnumpy()
    for b in tw:
        b.merge()
        assert not b.lora_b.data().asnumpy().any()
    np.testing.assert_allclose(tnet(tx).asnumpy(), pred, rtol=2e-5,
                               atol=1e-5)


def test_gpt_trunk_lora_finetuning():
    """test_model_zoo.py:652 on the port: the trunk-LoRA model with the
    base weights starts equal to the base, freeze_for_lora counts as the
    JAX package's, eight Adam steps lower the loss and move nothing
    frozen."""
    base = tgpt.gpt_tiny(scan_layers=True, device=cpu())
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 100, (2, 16)))
    ref = base(ids)
    lnet = tgpt.gpt_tiny(scan_layers=True, lora_rank=4, lora_alpha=8,
                         device=cpu())
    bmap = {n[len(base.prefix):]: p for n, p in
            base.collect_params().items()}
    for n, p in lnet.collect_params().items():
        if "lora" not in n:
            p.set_data(bmap[n[len(lnet.prefix):]].data())
    np.testing.assert_allclose(lnet(ids).detach().numpy(),
                               ref.detach().numpy(), rtol=2e-5, atol=2e-5)
    jnet = jgpt.gpt_tiny(scan_layers=True, lora_rank=4, lora_alpha=8)
    jnet.initialize()
    jnet(nd.array(ids.numpy().astype(np.float32)))
    assert lora.freeze_for_lora(lnet) == jlora.freeze_for_lora(jnet)
    tr = gluon.Trainer(lnet.collect_params(), "adam",
                       {"learning_rate": 5e-3})
    frozen = {n: p.data().asnumpy().copy()
              for n, p in lnet.collect_params().items()
              if p.grad_req == "null"}
    with cpu():
        x = NDArray(ids, cpu())
    losses = []
    for _ in range(8):
        with autograd.record():
            loss = tgpt.GPTLMLoss()(lnet(x), x)
        loss.backward()
        tr.step(2)
        losses.append(float(loss.asnumpy()))
    assert losses[-1] < losses[0]
    for n, p in lnet.collect_params().items():
        if n in frozen:
            np.testing.assert_array_equal(p.data().asnumpy(), frozen[n])


@pytest.mark.parametrize("spec,env", [
    (None, {}), ("full", {}), (True, {}), ("all", {}), ("dots", {}),
    ("dots_no_batch", {}), ("none", {"MXNET_BACKWARD_DO_MIRROR": "1"}),
    (None, {"MXNET_BACKWARD_DO_MIRROR": "1"}), (None, {"MXTPU_REMAT":
                                                       "dots"}),
    (None, {"MXTPU_REMAT": "save_every_k:2"}), ("save_every_k:3", {}),
])
def test_remat_policies_resolve_as_jax(monkeypatch, spec, env):
    """canonical, env_default and trunk_policy give the JAX registry's
    answers (the trunk policy's kind and chunk size)."""
    for k in ("MXNET_BACKWARD_DO_MIRROR", "MXTPU_REMAT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert remat.canonical(spec) == jremat.canonical(spec)
    assert remat.env_default(spec) == jremat.env_default(spec)
    mine, want = remat.trunk_policy(spec), jremat.trunk_policy(spec)
    assert (mine is None) == (want is None)
    if want is not None:
        assert mine[0] == want[0]
        if want[0] == "every":
            assert mine[1] == want[1]
    assert remat.names() == jremat.names()
    with pytest.raises(Exception, match="unknown remat policy"):
        remat.canonical("sometimes")


def _drop_net(remat_policy=None):
    """Dense -> Dropout(0.3) -> Dense, hybridized, from a fixed seed."""
    net = gluon.nn.HybridSequential(prefix="rd_")
    with net.name_scope():
        net.add(gluon.nn.Dense(16, activation="tanh", in_units=8),
                gluon.nn.Dropout(0.3), gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(9))
    if remat_policy:
        net.hybridize(remat=remat_policy)
    else:
        net.hybridize()
    return net


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_hybridize_remat_matches(policy):
    """test_parallel.py:813 with dropout: hybridize(remat=) gives the
    outputs and gradients of the plain hybridized net bitwise (the
    recompute takes the forward's masks), on the NDArray path."""
    with cpu():
        x = NDArray(torch.from_numpy(np.random.RandomState(2).randn(
            4, 8).astype(np.float32)), cpu())
    outs, grads = [], []
    for p in (None, policy):
        net = _drop_net(p)
        random.seed(4)
        with autograd.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        outs.append(out.asnumpy())
        grads.append([q.grad().asnumpy()
                      for q in net.collect_params().values()])
    np.testing.assert_array_equal(outs[0], outs[1])
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", [None, "full"])
def test_remat_inside_the_captured_step(monkeypatch, policy):
    """A BERT block hybridized with remat, dropout 0.1, three captured
    train_steps: the same losses and weights as the eager train_step
    (bitwise on the host, where the captured step runs without a graph)
    and as the run without remat."""
    runs = []
    for cap, pol in (("0", None), ("1", policy)):
        monkeypatch.setenv("MXTPU_CAPTURED_STEP", cap)
        net = tbert.bert_tiny(scan_layers=True, dropout=0.1, device=cpu())
        net.initialize(generator=torch.Generator().manual_seed(3))
        net.hybridize(**({"remat": pol} if pol else {}))
        tr = gluon.Trainer(net.collect_params(), "adamw",
                           {"learning_rate": 1e-3, "wd": 0.01})
        tok, mlm, nsp = (NDArray(torch.from_numpy(a), cpu())
                         for a in _bert_batch())
        random.seed(6)
        losses = [float(tr.train_step(net, tbert.BERTPretrainLoss(), tok,
                                      (mlm, nsp)).asnumpy())
                  for _ in range(3)]
        runs.append((losses, [p.data().asnumpy()
                              for p in net.collect_params().values()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


def _bert_batch(seed=2):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 1024, (4, 16))
    mlm = np.full((4, 16), -1, np.int64)
    mask = rng.rand(4, 16) < 0.3
    mlm[mask] = rng.randint(0, 1024, int(mask.sum()))
    return tokens, mlm, rng.randint(0, 2, (4,))


def test_capture_invalidates_on_lora_attach_freeze_merge(monkeypatch):
    """test_captured_step.py:230 on the port: apply_lora, freeze_for_lora
    and merge() bump the cache versions, so the captured step records
    again instead of replaying a stale step; the frozen base stays."""
    monkeypatch.setenv("MXTPU_CAPTURED_STEP", "1")
    net = gluon.nn.HybridSequential(prefix="cap_")
    with net.name_scope():
        net.add(gluon.nn.Dense(16, activation="relu", in_units=6),
                gluon.nn.Dense(3, in_units=16))
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(1))
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    rng = np.random.RandomState(3)
    x = NDArray(torch.from_numpy(rng.randn(8, 6).astype(np.float32)), cpu())
    y = NDArray(torch.from_numpy(rng.randint(0, 3, 8).astype(np.float32)),
                cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    captured.reset_counters()
    trainer.train_step(net, loss_fn, x, y)
    trainer.train_step(net, loss_fn, x, y)
    assert captured.cache_stats() == {"hits": 1, "misses": 1}
    v0 = net._cache_version
    wrapped = lora.apply_lora(net, rank=2, patterns=(".*",))
    assert net._cache_version > v0
    trainer2 = gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    captured.reset_counters()
    trainer2.train_step(net, loss_fn, x, y)
    assert captured.cache_stats()["misses"] == 1
    before = {n: p.data().asnumpy() for n, p in
              net.collect_params().items() if "lora" not in n}
    trainer2.train_step(net, loss_fn, x, y)
    for n, p in net.collect_params().items():
        if "lora" not in n:
            np.testing.assert_array_equal(before[n], p.data().asnumpy())
    v1 = net._cache_version
    lora.freeze_for_lora(net)
    assert net._cache_version > v1
    v2 = net._cache_version
    wrapped[0].merge()
    assert wrapped[0]._cache_version > 0 and net._cache_version == v2
    captured.reset_counters()
    trainer2.train_step(net, loss_fn, x, y)
    assert captured.cache_stats()["misses"] == 1


@pytest.fixture(scope="module")
def jax_bert_trained():
    """Three JAX gluon.Trainer AdamW steps of bert_tiny (hybridized, the
    loss too): the losses and the trained weights, once for both paths
    of the test below."""
    net = _jax_model("bert", True)
    start = _numpy(net)
    jtr = jgluon.Trainer(net.collect_params(), "adamw",
                         dict(BERT_TRAINER_OPT))
    tokens, mlm, nsp = _bert_batch()
    jx = nd.array(tokens.astype(np.float32))
    jy = (nd.array(mlm.astype(np.float32)), nd.array(nsp.astype(np.float32)))
    jloss_fn = jbert.BERTPretrainLoss()
    jloss_fn.hybridize()
    want = []
    for _ in range(3):
        with jautograd.record():
            jl = jloss_fn(net(jx), jy)
        jl.backward()
        jtr.step(4)
        want.append(float(jl.asnumpy()))
    return net.prefix, start, want, _numpy(net)


BERT_TRAINER_OPT = {"learning_rate": 1e-3, "wd": 0.01}


@pytest.mark.parametrize("path", ["eager", "train_step"])
def test_gluon_trainer_bert_matches_jax(jax_bert_trained, path):
    """Three gluon.Trainer AdamW steps of bert_tiny in both packages, the
    same weights and batch: the losses and the trained weights.  The
    port's ``train_step`` (the captured step; no graph on the host) takes
    the two labels as a tuple."""
    prefix, start, want, ref = jax_bert_trained
    model = _port_model("bert", True)
    convert.load_gluon_params(model, start)
    model.hybridize()
    ttr = gluon.Trainer(model.collect_params(), "adamw",
                        dict(BERT_TRAINER_OPT))
    tokens, mlm, nsp = _bert_batch()
    tx, ty = NDArray(torch.from_numpy(tokens), cpu()), (
        NDArray(torch.from_numpy(mlm), cpu()),
        NDArray(torch.from_numpy(nsp), cpu()))
    tloss_fn = tbert.BERTPretrainLoss()
    got = []
    for _ in range(3):
        if path == "eager":
            with autograd.record():
                tl = tloss_fn(model(tx), ty)
            tl.backward()
            ttr.step(4)
        else:
            tl = ttr.train_step(model, tloss_fn, tx, ty)
        got.append(float(tl.asnumpy()))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for name, p in model.collect_params().items():
        np.testing.assert_allclose(
            p.data().asnumpy(), ref[prefix + name[len(model.prefix):]],
            rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def test_bench_bert_paths_on_the_host(monkeypatch):
    """bench_bert's three paths on bert_tiny at the host: the line names
    its path, the loss falls, and the eager Gluon loop and the captured
    train_step give the same losses."""
    from mxnet_tpu_torch.tools import bench_bert

    monkeypatch.setattr(bench_bert.bert, "bert_base", tbert.bert_tiny)
    res = {p: bench_bert.run(batch=2, seq=32, steps=2, device=cpu(),
                             path=p) for p in bench_bert.PATHS}
    for p, r in res.items():
        assert r["path"] == p and r["losses"][-1] < r["losses"][0]
    assert res["gluon"]["losses"] == res["captured"]["losses"]
    with pytest.raises(ValueError, match="path must be one of"):
        bench_bert.run(batch=2, seq=32, steps=1, device=cpu(), path="x")
