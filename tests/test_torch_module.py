"""The port's Module path against the JAX package's, on the CPU.

``Module.fit`` for three SGD-momentum steps against the JAX ``Module``
(parameters and auxiliary states), ``predict``, ``score`` and
``save_checkpoint``/``load_checkpoint`` across the packages,
``convert.load_module_params``, optimizer
states through ``Module.load``, the Monitor under ``fit``, and
``BucketingModule`` against JAX Modules, one a bucket, whose parameters
``set_params`` carries from step to step (the JAX package's own
``BucketingModule`` fails on deleted buffers, ROADMAP queue 3).  Then a
Gluon convnet traced as a symbol: its Executor's training forward and
backward against the block's own under ``autograd.record()``, BatchNorm's
moving statistics included, and ``Module.fit`` over it.

Tolerances: outputs, parameters and auxiliary states rtol 2e-4 /
atol 2e-5, gradients rtol 2e-3 / atol 2e-4.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def _on_host():
    with cpu():
        yield


def _mlp(m):
    data = m.sym.Variable("data")
    h = m.sym.FullyConnected(data, m.sym.Variable("fc1_weight"),
                             m.sym.Variable("fc1_bias"), num_hidden=16,
                             name="fc1")
    h = m.sym.Activation(h, act_type="relu", name="relu1")
    out = m.sym.FullyConnected(h, m.sym.Variable("fc2_weight"),
                               m.sym.Variable("fc2_bias"), num_hidden=4,
                               name="fc2")
    return m.sym.SoftmaxOutput(out, m.sym.Variable("softmax_label"),
                               name="softmax")


def _data(seed, n=48):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2, 2, (4, 10)).astype(np.float32)
    y = rng.randint(0, 4, n)
    x = centers[y] + rng.normal(0, 0.4, (n, 10)).astype(np.float32)
    return x, y.astype(np.float32)


def _weights(seed):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.3,
            "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.3,
            "fc2_bias": rng.randn(4).astype(np.float32) * 0.1}


def _fit(m, sym, x, y, w):
    it = m.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    mod = m.mod.Module(sym)
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=dict(SGD),
            arg_params={k: m.nd.array(v) for k, v in w.items()},
            eval_metric="acc")
    return mod, it


def _params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.fixture(scope="module")
def fitted():
    """Both packages' Modules after three SGD-momentum steps from the
    same weights on the same batches."""
    x, y = _data(0)
    w = _weights(1)
    jsym = _mlp(mx)
    tsym = tmx.sym.fromjson(jsym.tojson())
    with cpu():
        tmod, tit = _fit(tmx, tsym, x, y, w)
    jmod, jit = _fit(mx, jsym, x, y, w)
    return jmod, jit, tmod, tit


def test_module_fit_matches_jax(fitted):
    jmod, _, tmod, _ = fitted
    jarg, jaux = _params(jmod)
    targ, taux = _params(tmod)
    _close(targ, jarg, OUT_TOL)
    _close(taux, jaux, OUT_TOL)
    assert tmod._optimizer.rescale_grad == 1.0 / 16
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(), **OUT_TOL)


def test_module_predict_score_checkpoint_cross(fitted, tmp_path):
    """predict and score agree; a checkpoint of either package loads in
    the other's Module and predicts the same."""
    jmod, jit, tmod, tit = fitted
    jp = jmod.predict(jit).asnumpy()
    tp = tmod.predict(tit).asnumpy()
    assert tp.shape == (48, 4)
    np.testing.assert_allclose(tp, jp, **OUT_TOL)
    assert tmod.score(tit, "acc")[0][1] == jmod.score(jit, "acc")[0][1]
    tmod.save_checkpoint(str(tmp_path / "t"), 3)
    sym, arg, aux = mx.model.load_checkpoint(str(tmp_path / "t"), 3)
    assert sym.list_arguments() == tmod.symbol.list_arguments()
    jm2 = mx.mod.Module(sym)
    jm2.bind(data_shapes=jit.provide_data, label_shapes=jit.provide_label)
    jm2.init_params(arg_params=arg, aux_params=aux)
    np.testing.assert_allclose(jm2.predict(jit).asnumpy(), tp, **OUT_TOL)
    jmod.save_checkpoint(str(tmp_path / "j"), 3)
    tm2 = tmx.mod.Module.load(str(tmp_path / "j"), 3)
    tm2.bind(data_shapes=tit.provide_data, label_shapes=tit.provide_label)
    tm2.init_params()
    np.testing.assert_allclose(tm2.predict(tit).asnumpy(), jp, **OUT_TOL)


def test_load_module_params_from_jax(fitted):
    """``convert.load_module_params`` carries a JAX Module's parameters
    into a bound port Module (same predictions), and refuses a missing or
    mis-shaped entry before copying any."""
    from mxnet_tpu_torch import convert

    jmod, jit, _, tit = fitted
    arg, aux = _params(jmod)
    mod = tmx.mod.Module(tmx.sym.fromjson(jmod.symbol.tojson()))
    mod.bind(data_shapes=tit.provide_data, label_shapes=tit.provide_label)
    bad = dict(arg, fc1_weight=arg["fc1_weight"][:, :3])
    for wrong in ({k: v for k, v in arg.items() if k != "fc2_bias"}, bad):
        with pytest.raises(tmx.MXNetError):
            convert.load_module_params(mod, wrong, aux)
        assert not mod.params_initialized
    assert not mod._exec.arg_dict["fc1_weight"].asnumpy().any()
    convert.load_module_params(mod, arg, aux)
    np.testing.assert_allclose(mod.predict(tit).asnumpy(),
                               jmod.predict(jit).asnumpy(), **OUT_TOL)


def test_module_optimizer_states_and_monitor(tmp_path):
    """A checkpoint with optimizer states resumes momentum exactly; the
    Monitor under fit collects the fc nodes' statistics."""
    x, y = _data(2)
    w = _weights(3)
    sym = _mlp(tmx)
    mod, it = _fit(tmx, sym, x, y, w)
    mod.save_checkpoint(str(tmp_path / "s"), 1, save_optimizer_states=True)
    again = tmx.mod.Module.load(str(tmp_path / "s"), 1,
                                load_optimizer_states=True)
    again.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    again.init_params()
    again.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    it.reset()
    batch = next(iter(it))
    for m in (mod, again):
        m.forward_backward(batch)
        m.update()
    _close(_params(again)[0], _params(mod)[0], dict(rtol=0, atol=0))
    mon = tmx.monitor.Monitor(interval=2, pattern=".*fc.*")
    mod2 = tmx.mod.Module(sym)
    mod2.fit(it, num_epoch=1, optimizer="sgd", monitor=mon,
             initializer=tinit.Xavier())
    names = {name for _, name, _ in mon.queue}
    assert names == {"fc1_output", "fc2_output"}, names
    assert all(np.isfinite(float(s.asnumpy())) for _, _, s in mon.queue)


def _bucket_sym(m):
    def sym_gen(seq_len):
        pooled = m.sym.mean(m.sym.var("data"), axis=1)
        out = m.sym.FullyConnected(pooled, m.sym.var("fc_weight"),
                                   m.sym.var("fc_bias"), num_hidden=3,
                                   name="fc")
        return (m.sym.SoftmaxOutput(out, m.sym.var("softmax_label"),
                                    name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _bucket_batches(m, n_steps, seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2, 2, (3, 6)).astype(np.float32)
    out = []
    for step in range(n_steps):
        L = 8 if step % 2 == 0 else 4
        y = rng.randint(0, 3, 16)
        x = centers[y][:, None, :] + rng.normal(
            0, 0.3, (16, L, 6)).astype(np.float32)
        out.append((L, x, y.astype(np.float32)))
    return out


def _batch(m, L, x, y):
    return m.io.DataBatch(data=[m.nd.array(x)], label=[m.nd.array(y)],
                          bucket_key=L,
                          provide_data=[("data", (16, L, 6))],
                          provide_label=[("softmax_label", (16,))])


def test_bucketing_module_matches_jax_modules():
    """Two sequence buckets share their parameters (one storage) and
    train as one model: against a JAX Module per bucket, the parameters
    carried by set_params from step to step."""
    steps = _bucket_batches(tmx, 6, 4)
    rng = np.random.RandomState(5)
    w = {"fc_weight": rng.randn(3, 6).astype(np.float32),
         "fc_bias": np.zeros(3, np.float32)}
    opt = (("learning_rate", 0.5),)
    bm = tmx.mod.BucketingModule(_bucket_sym(tmx), default_bucket_key=8)
    bm.bind(data_shapes=[("data", (16, 8, 6))],
            label_shapes=[("softmax_label", (16,))])
    bm.init_params(arg_params={k: tmx.nd.array(v) for k, v in w.items()})
    bm.init_optimizer(optimizer="sgd", optimizer_params=opt)
    jmods = {}
    cur = {k: mx.nd.array(v) for k, v in w.items()}
    for L, x, y in steps:
        bm.forward(_batch(tmx, L, x, y), is_train=True)
        bm.backward()
        bm.update()
        if L not in jmods:
            sym, dn, ln = _bucket_sym(mx)(L)
            jm = mx.mod.Module(sym, data_names=dn, label_names=ln)
            jm.bind(data_shapes=[("data", (16, L, 6))],
                    label_shapes=[("softmax_label", (16,))])
            jm.init_params(arg_params=cur)
            jm.init_optimizer(optimizer="sgd", optimizer_params=opt)
            jmods[L] = jm
        jm = jmods[L]
        jm.set_params(cur, {})
        jm.forward(_batch(mx, L, x, y), is_train=True)
        jm.backward()
        jm.update()
        cur, _ = jm.get_params()
        cur = {k: v.copy() for k, v in cur.items()}
    _close(_params(bm)[0], {k: v.asnumpy() for k, v in cur.items()},
           OUT_TOL)
    a8 = bm._buckets[8]._exec.arg_dict["fc_weight"]
    a4 = bm._buckets[4]._exec.arg_dict["fc_weight"]
    assert a8 is a4 and a8._data.data_ptr() == a4._data.data_ptr()
    assert bm._buckets[4]._updater is bm._buckets[8]._updater


def _convnet():
    net = tgluon.nn.HybridSequential()
    net.add(tgluon.nn.Conv2D(8, 3, padding=1, use_bias=False),
            tgluon.nn.BatchNorm(), tgluon.nn.Activation("relu"),
            tgluon.nn.MaxPool2D(2), tgluon.nn.Flatten(),
            tgluon.nn.Dense(5))
    net.initialize(init=tinit.Xavier(),
                   generator=torch.Generator().manual_seed(6))
    return net


def test_gluon_graph_executor_trains_like_the_block():
    """A Gluon convnet called on a Variable: the bound graph's training
    forward, its backward and its BatchNorm moving statistics against the
    block's own under ``autograd.record()``; then Module.fit over it with
    SoftmaxOutput moves the statistics and keeps the weights finite."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 3, 12, 12).astype(np.float32)
    g = rng.randn(4, 5).astype(np.float32)
    net = _convnet()
    sym = net(tmx.sym.var("data"))
    assert len(sym.list_auxiliary_states()) == 2
    with torch.no_grad():
        net(torch.from_numpy(x))          # completes the deferred shapes
    params = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    args = {k: v for k, v in params.items() if k in sym.list_arguments()}
    aux = {k: v for k, v in params.items()
           if k in sym.list_auxiliary_states()}
    exe = sym.simple_bind(data=x.shape, grad_req={k: "write" for k in args})
    exe.copy_params_from({k: tmx.nd.array(v) for k, v in args.items()},
                         {k: tmx.nd.array(v) for k, v in aux.items()})
    out = exe.forward(is_train=True, data=tmx.nd.array(x))[0]
    exe.backward(out_grads=tmx.nd.array(g))
    xs = tmx.nd.array(x)
    with tmx.autograd.record():
        want = net(xs)
    want.backward(tmx.nd.array(g))
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **OUT_TOL)
    cp = net.collect_params()
    for k in args:
        np.testing.assert_allclose(exe.grad_dict[k].asnumpy(),
                                   cp[k].grad().asnumpy(), **GRAD_TOL,
                                   err_msg=k)
    for k in aux:
        np.testing.assert_allclose(exe.aux_dict[k].asnumpy(),
                                   cp[k].data().asnumpy(), **OUT_TOL,
                                   err_msg=k)
        assert not np.allclose(exe.aux_dict[k].asnumpy(), aux[k])
    loss = tmx.sym.SoftmaxOutput(sym, tmx.sym.var("softmax_label"),
                                 name="softmax")
    it = tmx.io.NDArrayIter(np.repeat(x, 4, 0),
                            rng.randint(0, 5, 16).astype(np.float32),
                            batch_size=8, label_name="softmax_label")
    mod = tmx.mod.Module(loss)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(SGD), arg_params={
                k: tmx.nd.array(v) for k, v in args.items()},
            aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    arg2, aux2 = _params(mod)
    assert all(np.isfinite(v).all() for v in arg2.values())
    for k in aux:
        assert not np.allclose(aux2[k], aux[k]), k
