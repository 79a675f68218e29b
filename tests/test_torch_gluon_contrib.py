"""``gluon.contrib``: ``nn`` (``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SparseEmbedding``, ``SyncBatchNorm``, ``PixelShuffle*``),
``cnn.DeformableConvolution`` and ``Estimator``, the port's against the
JAX package's on the CPU, with the JAX weights carried across by
``convert.load_gluon_params``.  Tolerances: a layer's outputs rtol 1e-4 /
atol 1e-5, gradients and trained parameters rtol 2e-3 / atol 2e-4
(``tests/test_torch_operator.py``).
"""

import contextlib

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd
from mxnet_tpu.gluon import contrib as jcontrib

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import contrib as tcontrib

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _load(tblk, jblk):
    convert.load_gluon_params(tblk, {k: p.data().asnumpy() for k, p in
                                     jblk.collect_params().items()})


@pytest.mark.parametrize("kind", ["1d", "2d", "3d"])
def test_pixel_shuffle_matches_jax(kind):
    rng = np.random.RandomState(3)
    shape, factor, cls = {
        "1d": ((2, 6, 5), 3, "PixelShuffle1D"),
        "2d": ((2, 12, 3, 4), (2, 3), "PixelShuffle2D"),
        "3d": ((1, 16, 2, 3, 2), 2, "PixelShuffle3D")}[kind]
    x = rng.standard_normal(shape).astype(np.float32)
    want = getattr(jcontrib.nn, cls)(factor)(nd.array(x)).asnumpy()
    with cpu():
        got = getattr(tcontrib.nn, cls)(factor)(tnd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, want)


def test_contrib_concurrent_identity_sync_bn_match_jax():
    """Concurrent and HybridConcurrent over Dense and Identity branches,
    then SyncBatchNorm in training mode: outputs, gradients, and the
    moved running statistics."""
    rng = np.random.RandomState(4)
    x = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)

    def build(pkg, contrib):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            branches = contrib.nn.HybridConcurrent(axis=1)
            with branches.name_scope():
                branches.add(pkg.gluon.nn.Conv2D(2, 3, padding=1),
                             contrib.nn.Identity())
            net.add(branches, contrib.nn.SyncBatchNorm(num_devices=1))
        return net

    mx.random.seed(4)
    jnet = build(mx, jcontrib)
    jnet.initialize(init=mx.init.Xavier())
    jnet(nd.array(x))
    with cpu():
        tnet = build(tmx, tcontrib)
        tnet.initialize()
        tnet(tnd.array(x))
    _load(tnet, jnet)
    outs = []
    for pkg, net, ctx in ((mx, jnet, contextlib.nullcontext()),
                          (tmx, tnet, cpu())):
        with ctx:
            a = pkg.nd.array(x)
            with pkg.autograd.record():
                y = net(a)
                (y * y).sum().backward()
            outs.append([y.asnumpy()] + [
                p.grad().asnumpy() if p.grad_req != "null" else
                p.data().asnumpy() for p in net.collect_params().values()])
    assert outs[0][0].shape == (4, 5, 5, 5)
    np.testing.assert_allclose(outs[1][0], outs[0][0], **FWD_TOL)
    for g, w in zip(outs[1][1:], outs[0][1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    seq = tcontrib.nn.Concurrent(axis=1)
    with cpu():
        seq.add(tcontrib.nn.Identity(), tcontrib.nn.Identity())
        np.testing.assert_array_equal(seq(tnd.array(x)).asnumpy(),
                                      np.concatenate([x, x], 1))


def test_sparse_embedding_matches_jax():
    """SparseEmbedding: the lookup, and its weight gradient (row-sparse in
    the port, dense in the JAX package) densified."""
    ids = np.array([[1, 3, 3], [0, 7, 1]], np.float32)
    mx.random.seed(5)
    jblk = jcontrib.nn.SparseEmbedding(8, 4)
    jblk.initialize()
    with cpu():
        tblk = tcontrib.nn.SparseEmbedding(8, 4)
        tblk.initialize()
    _load(tblk, jblk)
    with jag.record():
        jy = jblk(nd.array(ids))
        (jy * jy).sum().backward()
    with cpu(), tag.record():
        ty = tblk(tnd.array(ids))
        (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), **FWD_TOL)
    g = tblk.weight.grad()
    assert g.stype == "row_sparse"
    np.testing.assert_allclose(g.tostype("default").asnumpy(),
                               jblk.weight.grad().asnumpy(), **GRAD_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(groups=2,
                                             num_deformable_group=2,
                                             strides=2)], ids=str)
def test_deformable_convolution_layer_matches_jax(kw):
    """The layer: the offset branch (random weights here, so the taps
    move) and the deformable convolution, outputs and gradients."""
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 4, 7, 7)).astype(np.float32)

    def make(contrib):
        return contrib.cnn.DeformableConvolution(
            4, kernel_size=3, padding=1, activation="relu", in_channels=4,
            **kw)

    mx.random.seed(6)
    jblk = make(jcontrib)
    jblk.initialize(init=mx.init.Xavier())
    for p in (jblk.offset_weight, jblk.offset_bias):
        p.set_data(nd.array(rng.standard_normal(p.shape) * 0.3))
    jblk.hybridize()
    with cpu():
        tblk = make(tcontrib)
        tblk.initialize()
    _load(tblk, jblk)
    res = []
    for pkg, blk, ctx in ((mx, jblk, contextlib.nullcontext()), (tmx, tblk, cpu())):
        with ctx:
            a = pkg.nd.array(x)
            a.attach_grad()
            with pkg.autograd.record():
                y = blk(a)
                (y * y).sum().backward()
            res.append([y.asnumpy(), a.grad.asnumpy()] + [
                p.grad().asnumpy() for p in blk.collect_params().values()])
    np.testing.assert_allclose(res[1][0], res[0][0], **FWD_TOL)
    for g, w in zip(res[1][1:], res[0][1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_estimator_fit_matches_jax():
    """``Estimator.fit`` for two epochs over the same batches (SGD on a
    small MLP): the same trained parameters and accuracy as the JAX
    package's; the metric moves."""
    rng = np.random.RandomState(7)
    X = rng.standard_normal((64, 6)).astype(np.float32)
    Y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    batches = [(X[i:i + 16], Y[i:i + 16]) for i in range(0, 64, 16)]

    def run(pkg, contrib, params=None):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6),
                    pkg.gluon.nn.Dense(2, in_units=8))
        net.initialize(init=pkg.init.Xavier())
        if params is not None:
            convert.load_gluon_params(net, params)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        est = contrib.Estimator(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                                metrics=["acc"], trainer=trainer)
        data = [(pkg.nd.array(a), pkg.nd.array(b)) for a, b in batches]
        accs = []
        est.fit(data, epochs=2, epoch_end_callback=lambda e, ms, t:
                accs.append(ms[0].get()[1]))
        before = est.evaluate(data)[0][1]
        return net, accs, before

    mx.random.seed(7)
    jnet, jaccs, jeval = run(mx, jcontrib)
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    # the JAX net's starting point: rebuild it from the same seed
    mx.random.seed(7)
    start = mx.gluon.nn.HybridSequential()
    with start.name_scope():
        start.add(mx.gluon.nn.Dense(8, activation="relu", in_units=6),
                  mx.gluon.nn.Dense(2, in_units=8))
    start.initialize(init=mx.init.Xavier())
    start_params = {k: p.data().asnumpy() for k, p in
                    start.collect_params().items()}
    with cpu():
        tnet, taccs, teval = run(tmx, tcontrib, start_params)
    assert taccs == jaccs and teval == jeval
    assert len(taccs) == 2 and taccs[-1] > 0.5
    for (k, t), j in zip(tnet.collect_params().items(), params.values()):
        np.testing.assert_allclose(t.data().asnumpy(), j, err_msg=k,
                                   **GRAD_TOL)
