"""The port's Gluon core against the JAX package's, on the CPU, with the
same numpy inputs through both and the JAX weights carried across by
``convert.load_gluon_params``: ``Parameter`` (deferred initialisation,
``cast``, ``grad_req``, the mults), ``Block`` (names, ``collect_params``,
``initialize``, ``save``/``load_parameters``, its life as a
``torch.nn.Module``), every layer family's forward and gradients in both
layouts, BatchNorm's modes and running statistics in f32 and bf16, every
loss of ``loss.py``, and the tie rules of ReLU and max-pooling.  Outputs
are held at rtol 2e-4 / atol 2e-5 and gradients at 2e-3 / 2e-4
(``tests/test_parallel.py``'s tolerances); bf16 against the port's own
f32 at 0.05 max|f32|."""

import copy

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert, initializer
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import (Constant, DeferredInitializationError,
                                   Parameter, ParameterDict)
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel_mesh
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


def _np(p):
    return p.data().asnumpy()


def _randomize(net, seed):
    rng = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        if name.endswith(("gamma", "running_var", "alpha")):
            p.set_data(nd.array(rng.uniform(0.5, 1.5, p.shape)))
        elif name.endswith(("beta", "running_mean", "bias")):
            p.set_data(nd.array(rng.uniform(-0.3, 0.3, p.shape)))


def _pair(make, x, seed=0):
    """The JAX layer (Xavier weights, random BN/bias parameters,
    materialised on ``x``) and the port's with its weights."""
    mx.random.seed(seed)
    jnet = make(jnn)
    jnet.initialize(init=mx.init.Xavier())
    with jag.pause():
        jnet(nd.array(x))
    _randomize(jnet, seed + 1)
    jnet.hybridize()
    with cpu():
        tnet = make(tnn)
        tnet.initialize()
    convert.load_gluon_params(
        tnet, {k: _np(p) for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _run(pkg_nd, ag, net, x, c, train):
    """Forward in the given mode through the NDArray path, and the
    gradients of sum(out * c) with respect to x and every parameter."""
    xa = pkg_nd.array(x, dtype=x.dtype)
    diff = x.dtype != np.int32
    if diff:
        xa.attach_grad()
    with ag.record(train_mode=train):
        out = net(xa)
        loss = (out * pkg_nd.array(c)).sum()
    loss.backward()
    grads = {k[len(net.prefix):]: p.grad().asnumpy()
             for k, p in net.collect_params().items() if p.grad_req != "null"}
    aux = {k[len(net.prefix):]: _np(p)
           for k, p in net.collect_params().items() if p.grad_req == "null"}
    return out.asnumpy(), (xa.grad.asnumpy() if diff else None), grads, aux


def _compare(make, x, train=False, seed=0):
    jnet, tnet = _pair(make, x, seed)
    with jag.pause():
        shape = jnet(nd.array(x, dtype=x.dtype)).shape
    c = np.random.RandomState(seed + 7).standard_normal(shape).astype(
        np.float32)
    want = _run(nd, jag, jnet, x, c, train)
    with cpu():
        got = _run(tnd, tag, tnet, x, c, train)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    if want[1] is not None:
        np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    for k in want[3]:
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _last(x, layout):
    """x (channel-first) in ``layout``."""
    if layout[1] == "C":
        return x
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


# -- layers ----------------------------------------------------------------

LAYERS = {
    "dense": (lambda nn: nn.Dense(5, activation="tanh"), (3, 4, 2)),
    "dense_no_flatten": (lambda nn: nn.Dense(5, flatten=False,
                                             use_bias=False), (3, 4, 6)),
    "flatten": (lambda nn: nn.Flatten(), (2, 3, 4)),
    "leaky_relu": (lambda nn: nn.LeakyReLU(0.1), (3, 5)),
    "prelu": (lambda nn: nn.PReLU(), (3, 5)),
    "elu": (lambda nn: nn.ELU(0.7), (3, 5)),
    "selu": (lambda nn: nn.SELU(), (3, 5)),
    "gelu": (lambda nn: nn.GELU(), (3, 5)),
    "swish": (lambda nn: nn.Swish(1.5), (3, 5)),
    "layer_norm": (lambda nn: nn.LayerNorm(), (3, 6)),
    "group_norm": (lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    "instance_norm": (lambda nn: nn.InstanceNorm(scale=True), (2, 3, 4, 4)),
    "reflection_pad": (lambda nn: nn.ReflectionPad2D(1), (1, 2, 4, 4)),
    "dropout_predict": (lambda nn: nn.Dropout(0.5), (3, 5)),
    "hybrid_lambda": (lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + F.sigmoid(x)), (3, 5)),
    "sequential": (lambda nn: _seq(nn), (2, 6)),
}


def _seq(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.Dense(4))
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make, shape = LAYERS[name]
    _compare(make, _x(*shape, seed=len(name)))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu", "silu", "swish", "erf"])
def test_activation_matches_jax(act):
    _compare(lambda nn: nn.Activation(act), _x(3, 7, seed=3))


CONV = {
    "conv1d": (lambda nn, lay: nn.Conv1D(4, 3, padding=1, layout=lay),
               (2, 3, 9), ("NCW", "NWC")),
    "conv2d": (lambda nn, lay: nn.Conv2D(6, 3, strides=2, padding=1,
                                         layout=lay), (2, 4, 9, 9),
               ("NCHW", "NHWC")),
    "conv2d_grouped": (lambda nn, lay: nn.Conv2D(4, (3, 1), groups=2,
                                                 dilation=(2, 1),
                                                 use_bias=False,
                                                 layout=lay), (1, 4, 8, 6),
                       ("NCHW", "NHWC")),
    "conv3d": (lambda nn, lay: nn.Conv3D(4, 2, layout=lay),
               (1, 2, 4, 5, 5), ("NCDHW", "NDHWC")),
    "conv2d_transpose": (lambda nn, lay: nn.Conv2DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, layout=lay),
        (2, 4, 5, 5), ("NCHW", "NHWC")),
    "conv1d_transpose": (lambda nn, lay: nn.Conv1DTranspose(
        2, 3, strides=2, layout=lay), (2, 3, 6), ("NCW", "NWC")),
    "max_pool2d": (lambda nn, lay: nn.MaxPool2D(3, 2, 1, layout=lay),
                   (2, 3, 9, 9), ("NCHW", "NHWC")),
    "max_pool2d_ceil": (lambda nn, lay: nn.MaxPool2D(
        3, 2, 0, ceil_mode=True, layout=lay), (2, 3, 8, 8),
        ("NCHW", "NHWC")),
    "avg_pool2d": (lambda nn, lay: nn.AvgPool2D(2, layout=lay),
                   (2, 3, 8, 8), ("NCHW", "NHWC")),
    "avg_pool2d_ceil_excl": (lambda nn, lay: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False, layout=lay),
        (2, 3, 8, 8), ("NCHW", "NHWC")),
    "avg_pool1d": (lambda nn, lay: nn.AvgPool1D(3, 2, 1, layout=lay),
                   (2, 3, 9), ("NCW", "NWC")),
    "max_pool3d": (lambda nn, lay: nn.MaxPool3D(2, layout=lay),
                   (1, 2, 4, 4, 4), ("NCDHW", "NDHWC")),
    "global_avg": (lambda nn, lay: nn.GlobalAvgPool2D(layout=lay),
                   (2, 3, 5, 5), ("NCHW", "NHWC")),
    "global_max": (lambda nn, lay: nn.GlobalMaxPool1D(layout=lay),
                   (2, 3, 7), ("NCW", "NWC")),
    "batch_norm": (lambda nn, lay: nn.BatchNorm(axis=lay.index("C")),
                   (4, 3, 5, 5), ("NCHW", "NHWC")),
}


CONV_CASES = [(name, last, False) for name in sorted(CONV)
              for last in (False, True)] + [("batch_norm", last, True)
                                            for last in (False, True)]


@pytest.mark.parametrize("name,last,train", CONV_CASES)
def test_conv_pool_norm_layers_match_jax(name, last, train):
    """Convolutions, their transposes, the pools and BatchNorm in both
    layouts, in predict mode; BatchNorm in training mode too, which moves
    its running statistics (held as well)."""
    make, shape, layouts = CONV[name]
    layout = layouts[last]
    x = _last(_x(*shape, seed=len(name)), layout)
    _compare(lambda nn: make(nn, layout), x, train=train)


def test_embedding_matches_jax():
    ids = np.array([[1, 4, 9], [0, 4, 2]], np.int32)
    _compare(lambda nn: nn.Embedding(10, 5), ids)
    # sparse_grad=True: the same outputs, and a compact gradient whose
    # dense view is the JAX package's
    _compare(lambda nn: nn.Embedding(10, 5, sparse_grad=True), ids)


def test_relu_and_max_pool_ties_follow_jax():
    """ReLU's gradient at exactly 0 is 1/2 (``jnp.maximum`` splits ties),
    for the Activation layer and nd.relu alike; max-pooling sends a
    window's gradient to its first maximum.  Inputs with exact zeros and
    equal maxima."""
    x = np.array([[-1.0, 0.0, 2.0, 0.0, -0.0]], np.float32)
    _compare(lambda nn: nn.Activation("relu"), x)
    with cpu():
        a = tnd.array(x)
        a.attach_grad()
        with tag.record():
            tnd.relu(a).sum().backward()
    np.testing.assert_array_equal(a.grad.asnumpy(),
                                  [[0.0, 0.5, 1.0, 0.5, 0.5]])
    p = np.zeros((1, 1, 6, 6), np.float32)
    p[0, 0, 0, 0] = p[0, 0, 1, 1] = p[0, 0, 4, 5] = p[0, 0, 5, 4] = 3.0
    p[0, 0, 2:4, 2:4] = 1.0
    _compare(lambda nn: nn.MaxPool2D(2, 2), p)
    _compare(lambda nn: nn.MaxPool2D(3, 2, 1), p)


# -- BatchNorm -------------------------------------------------------------

def test_batch_norm_modes_and_running_update():
    """Predict mode normalises with the running statistics and leaves them;
    training mode normalises with the batch's and moves them to
    0.9 running + 0.1 batch (biased variance)."""
    x = _x(6, 3, 4, 4, seed=11) * 2 + 1
    with cpu():
        bn = tnn.BatchNorm(in_channels=3)
        bn.initialize()
        rm, rv = bn.running_mean.data().asnumpy(), \
            bn.running_var.data().asnumpy()
        out = bn(tnd.array(x)).asnumpy()
        np.testing.assert_allclose(out, x / np.sqrt(1 + 1e-5), rtol=RTOL,
                                   atol=ATOL)
        assert (bn.running_mean.data().asnumpy() == rm).all()
        with tag.record():
            out = bn(tnd.array(x)).asnumpy()
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    want = (x - mean[:, None, None]) / np.sqrt(var[:, None, None] + 1e-5)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.data().asnumpy(),
                               0.9 * rm + 0.1 * mean, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn.running_var.data().asnumpy(),
                               0.9 * rv + 0.1 * var, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_bf16_keeps_its_dtype(layout):
    """cast("bfloat16") casts BatchNorm's parameters and running statistics;
    a bf16 training step keeps them bf16 and lands within 0.05 max|f32| of
    the f32 layer; cast("float16") keeps them f32."""
    axis = layout.index("C")
    x = _last(_x(8, 4, 5, 5, seed=12) * 3 + 2, layout)
    with cpu():
        f32 = tnn.BatchNorm(axis=axis)
        f32.initialize()
        f32(torch.from_numpy(x))
        bf = copy.deepcopy(f32).cast("bfloat16")
        for net, inp in ((f32, x), (bf, x)):
            t = torch.from_numpy(inp)
            with tag.train_mode():
                net(t.to(net.gamma.data()._data.dtype))
        for p in bf.collect_params().values():
            assert p.data()._data.dtype == torch.bfloat16, p.name
        with tag.train_mode():
            o32 = f32(torch.from_numpy(x)).detach()
            o16 = bf(torch.from_numpy(x).bfloat16()).detach()
        assert o16.dtype == torch.bfloat16
        tol = 0.05 * float(o32.abs().max())
        assert float((o16.float() - o32).abs().max()) <= tol
        for name in ("running_mean", "running_var"):
            a = getattr(bf, name).data()._data.float()
            b = getattr(f32, name).data()._data
            assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())
        half = tnn.BatchNorm(in_channels=4)
        half.initialize()
        half.cast("float16")
        assert all(p.data()._data.dtype == torch.float32
                   for p in half.collect_params().values())


# -- losses ----------------------------------------------------------------

def _loss_case(name):
    rng = np.random.RandomState(len(name))
    pred = rng.standard_normal((4, 5)).astype(np.float32)
    lab = rng.standard_normal((4, 5)).astype(np.float32)
    cls = rng.randint(0, 5, 4).astype(np.float32)
    prob = rng.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
    binary = rng.randint(0, 2, (4, 5)).astype(np.float32)
    signed = binary * 2 - 1
    sw = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    return {
        "l2": (lambda L: L.L2Loss(), [pred, lab]),
        "l2_weighted": (lambda L: L.L2Loss(weight=0.5), [pred, lab, sw]),
        "l1": (lambda L: L.L1Loss(), [pred, lab]),
        "sigmoid_bce": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                        [pred, binary]),
        "sigmoid_bce_pos_weight": (
            lambda L: L.SigmoidBinaryCrossEntropyLoss(),
            [pred, binary, None, np.full((4, 5), 2.0, np.float32)]),
        "sigmoid_bce_from_sigmoid": (
            lambda L: L.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True),
            [prob, binary]),
        "softmax_ce": (lambda L: L.SoftmaxCrossEntropyLoss(), [pred, cls]),
        "softmax_ce_dense": (lambda L: L.SoftmaxCrossEntropyLoss(
            sparse_label=False), [pred, prob]),
        "softmax_ce_from_logits": (lambda L: L.SoftmaxCrossEntropyLoss(
            from_logits=True), [pred, cls]),
        "kl_div": (lambda L: L.KLDivLoss(), [pred, prob]),
        "kl_div_logits": (lambda L: L.KLDivLoss(from_logits=False),
                          [pred, prob]),
        "huber": (lambda L: L.HuberLoss(rho=0.5), [pred, lab]),
        "hinge": (lambda L: L.HingeLoss(), [pred, signed]),
        "squared_hinge": (lambda L: L.SquaredHingeLoss(), [pred, signed]),
        "logistic": (lambda L: L.LogisticLoss(), [pred, signed]),
        "logistic_binary": (lambda L: L.LogisticLoss(label_format="binary"),
                            [pred, binary]),
        "triplet": (lambda L: L.TripletLoss(), [pred, lab, prob]),
        "poisson_nll": (lambda L: L.PoissonNLLLoss(), [pred, prob * 3]),
        "poisson_nll_full": (lambda L: L.PoissonNLLLoss(
            from_logits=False, compute_full=True), [prob, prob * 3]),
        "cosine_embedding": (lambda L: L.CosineEmbeddingLoss(),
                             [pred, lab, np.array([1, -1, 1, -1],
                                                  np.float32)]),
        "ctc": (lambda L: L.CTCLoss(),
                [rng.standard_normal((2, 6, 4)).astype(np.float32),
                 np.array([[1, 2], [3, 0]], np.float32)]),
    }[name]


LOSSES = ["l2", "l2_weighted", "l1", "sigmoid_bce", "sigmoid_bce_pos_weight",
          "sigmoid_bce_from_sigmoid", "softmax_ce", "softmax_ce_dense",
          "softmax_ce_from_logits", "kl_div", "kl_div_logits", "huber",
          "hinge", "squared_hinge", "logistic", "logistic_binary",
          "triplet", "poisson_nll", "poisson_nll_full", "cosine_embedding",
          "ctc"]


def _loss_run(pkg_nd, ag, L, make, arrays):
    args = [None if a is None else pkg_nd.array(a) for a in arrays]
    args[0].attach_grad()
    with ag.record():
        out = make(L)(*args)
        total = out.sum()
    total.backward()
    return out.asnumpy(), args[0].grad.asnumpy()


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name):
    make, arrays = _loss_case(name)
    if name == "ctc":
        # the JAX CTCLoss leaves the NDArray tape; its op is differentiated
        # with jax.grad instead
        import jax
        import jax.numpy as jnp
        from mxnet_tpu.ops.ctc import ctc_loss

        pred, label = (jnp.asarray(a) for a in arrays)

        def jax_loss(p):
            per_sample = ctc_loss(p, label)
            return per_sample.sum(), per_sample

        (_, jl), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            pred)
        want = (np.asarray(jl), np.asarray(jg))
    else:
        want = _loss_run(nd, jag, jloss, make, arrays)
    with cpu():
        got = _loss_run(tnd, tag, tloss, make, arrays)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_loss_takes_tensors_and_float_labels():
    pred = torch.from_numpy(_x(3, 4, seed=2))
    lab = torch.tensor([0.0, 3.0, 1.0])
    got = tloss.SoftmaxCrossEntropyLoss()(pred, lab)
    want = -torch.log_softmax(pred, -1)[torch.arange(3), lab.long()]
    torch.testing.assert_close(got, want)


# -- Parameter -------------------------------------------------------------

def test_parameter_deferred_init_and_cast():
    p = Parameter("w", shape=(3, 0), allow_deferred_init=True)
    with cpu():
        p.initialize(init=initializer.One())
    assert p._deferred_init
    with pytest.raises(DeferredInitializationError):
        p.data()
    p.cast("bfloat16")                   # while deferred
    p.shape = (3, 4)
    p._finish_deferred_init()
    d = p.data()
    assert d.shape == (3, 4) and d._data.dtype == torch.bfloat16
    assert (d.asnumpy() == 1).all() and d.context == cpu()
    assert isinstance(d._data, torch.nn.Parameter)
    with pytest.raises(AssertionError, match="incompatible"):
        p.shape = (3, 5)
    with pytest.raises(ValueError, match="invalid shape"):
        Parameter("v", shape=(0,)).initialize(ctx=cpu())
    with pytest.raises(RuntimeError, match="not been initialized"):
        Parameter("u", shape=(2,)).data()


def test_parameter_grad_req_and_registration():
    with cpu():
        net = tnn.Dense(3, in_units=2)
        net.initialize()
    names = dict(net.named_parameters())
    assert set(names) == {"weight", "bias"}
    net.bias.grad_req = "null"
    assert set(dict(net.named_parameters())) == {"weight"}
    assert set(dict(net.named_buffers())) == {"bias"}
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        net.bias.grad()
    net.bias.grad_req = "write"
    assert set(dict(net.named_parameters())) == {"weight", "bias"}
    assert net.bias.grad().shape == (3,)
    # a write through data() lands in the module's tensor
    net.weight.data()[:] = tnd.ones((3, 2), ctx=cpu())
    assert (dict(net.named_parameters())["weight"].detach() == 1).all()
    net.weight.set_data(np.full((3, 2), 2.0, np.float32))
    assert float(net(tnd.ones((1, 2), ctx=cpu())).asnumpy()[0, 0]) == \
        pytest.approx(4.0 + float(_np(net.bias)[0]))
    c = Constant("c", np.arange(3.0))
    with cpu():
        c.initialize()
    assert c.grad_req == "null"
    np.testing.assert_array_equal(_np(c), [0, 1, 2])


def test_parameter_mults_reach_the_trainer():
    x = _x(4, 3, seed=1)
    y = np.array([0, 1, 2, 1], np.float32)
    with cpu():
        net = tnn.Dense(3, in_units=3)
        net.initialize()
        net.bias.wd_mult = 0.0
        net.weight.lr_mult = 0.5
        tr = ShardedTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                            {"learning_rate": 0.1, "wd": 0.5},
                            mesh=data_parallel_mesh(1))
    w0, b0 = _np(net.weight).copy(), _np(net.bias).copy()
    with tag.train_mode():
        loss = tloss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x)), torch.from_numpy(y)).mean()
    gw, gb = torch.autograd.grad(loss, [net.weight._value(),
                                        net.bias._value()])
    tr.step(x, y)
    assert tr._wd_mults == [1.0, 0.0] and tr._lr_mults == [0.5, 1.0]
    np.testing.assert_allclose(_np(net.weight),
                               w0 - 0.05 * (gw.numpy() + 0.5 * w0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(net.bias), b0 - 0.1 * gb.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_parameter_dict_get_and_share():
    pd = ParameterDict("net_")
    w = pd.get("w", shape=(2, 0))
    assert pd.get("w", shape=(0, 3)) is w and w.shape == (2, 3)
    with pytest.raises(AssertionError, match="does not match"):
        pd.get("w", lr_mult=2.0)
    shared = ParameterDict("net_", shared=pd)
    assert shared.get("w") is w


# -- Block -------------------------------------------------------------------

def _model(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2), nn.Flatten())
        inner = nn.HybridSequential(prefix="head_")
        with inner.name_scope():
            inner.add(nn.Dense(6), nn.Dropout(0.0), nn.Dense(3))
        net.add(inner)
    return net


def test_block_names_match_jax():
    x = _x(2, 3, 6, 6, seed=5)
    jnet, tnet = _pair(_model, x)
    strip = (lambda net, sel=None: [k[len(net.prefix):] for k in
                                    net.collect_params(sel).keys()])
    assert strip(tnet) == strip(jnet)
    for sel in (".*weight", ".*batchnorm.*", ".*head_dense1.*"):
        assert strip(tnet, sel) == strip(jnet, sel)
        assert strip(tnet, sel)
    assert "head_dense1_bias" in strip(tnet)
    assert tnet[0].name.endswith("conv0") and tnet[5].prefix.endswith(
        "head_")
    _compare(_model, x, train=True)


def test_block_is_a_torch_module():
    with cpu():
        net = _model(tnn)
        net.initialize(init=initializer.Xavier())
        net(torch.zeros(1, 3, 6, 6))
    assert [k for k, _ in net.named_parameters()][:3] == [
        "0.weight", "0.bias", "1.gamma"]
    assert "1.running_mean" in net.state_dict()
    assert len(list(net.children())) == 6
    twin = copy.deepcopy(net)
    twin.cast("bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in twin.parameters())
    assert all(p.dtype == torch.float32 for p in net.parameters())
    for p in twin.collect_params().values():
        assert p.data()._data is dict(
            list(twin.named_parameters()) + list(twin.named_buffers()))[
            _struct(twin, p)]
    net.hybridize()
    assert net._active and net[5]._active


def _struct(net, param):
    return next(k for k, v in net._collect_params_with_prefix().items()
                if v is param)


def test_block_initialize_fills_every_parameter():
    with cpu():
        net = _model(tnn)
        net.initialize(init=initializer.Xavier(),
                       generator=torch.Generator().manual_seed(0))
        assert any(p._deferred_init
                   for p in net.collect_params().values())
        net(torch.zeros(2, 3, 6, 6))
    vals = {k[len(net.prefix):]: _np(p)
            for k, p in net.collect_params().items()}
    assert (vals["batchnorm0_running_mean"] == 0).all()
    assert (vals["batchnorm0_running_var"] == 1).all()
    assert (vals["batchnorm0_gamma"] == 1).all()
    assert (vals["conv0_bias"] == 0).all()
    bound = np.sqrt(3.0 / ((3 * 9 + 4 * 9) / 2.0))
    w = vals["conv0_weight"]
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.8 * bound
    # the module initializer takes a Block the same way, by Gluon name
    with cpu():
        other = _model(tnn)
        initializer.initialize(other, initializer.Xavier(), generator=
                               torch.Generator().manual_seed(0))
        other(torch.zeros(2, 3, 6, 6))
    for (k, a), b in zip(vals.items(), other.collect_params().values()):
        np.testing.assert_array_equal(_np(b), a, err_msg=k)


def test_save_and_load_parameters(tmp_path):
    x = _x(2, 3, 6, 6, seed=6)
    jnet, tnet = _pair(_model, x)
    f = str(tmp_path / "port.params")
    tnet.save_parameters(f)
    with cpu():
        back = _model(tnn)
        back.load_parameters(f, ctx=cpu())
        np.testing.assert_array_equal(back(tnd.array(x)).asnumpy(),
                                      tnet(tnd.array(x)).asnumpy())
    # the JAX package's file loads into the port (same .params layout)
    g = str(tmp_path / "jax.params")
    jnet.save_parameters(g)
    with cpu():
        from_jax = _model(tnn)
        from_jax.load_parameters(g, ctx=cpu())
        out = from_jax(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(out, jnet(nd.array(x)).asnumpy(), rtol=RTOL,
                               atol=ATOL)
    with cpu():
        bad = _model(tnn)
        bad.cast("bfloat16")
        with pytest.raises(AssertionError, match="dtype"):
            bad.load_parameters(f, ctx=cpu())
        bad.load_parameters(f, ctx=cpu(), cast_dtype=True)
        assert _np(bad[0].weight).dtype == np.float32   # read as f32
        assert bad[0].weight.data()._data.dtype == torch.bfloat16


def test_load_gluon_params_checks_before_copying():
    x = _x(2, 3, 6, 6, seed=7)
    jnet, tnet = _pair(_model, x)
    params = {k: _np(p) for k, p in jnet.collect_params().items()}
    before = {k: _np(p).copy() for k, p in tnet.collect_params().items()}
    key = next(k for k in params if k.endswith("conv0_weight"))
    for broken, msg in (
            (dict(params, **{key: params[key][:1]}), "shape"),
            ({k: v for k, v in params.items() if k != key}, "no single"),
            (dict(params, **{key[:-len("conv0_weight")] + "extra": params[
                key]}), "no parameter")):
        with pytest.raises(MXNetError, match=msg):
            convert.load_gluon_params(tnet, broken)
    for k, p in tnet.collect_params().items():
        np.testing.assert_array_equal(_np(p), before[k])


def test_nd_ops_of_the_nn_family_are_on_the_nd_namespace():
    for name in ("Convolution", "Deconvolution", "Pooling", "BatchNorm",
                 "LayerNorm", "RMSNorm", "InstanceNorm", "GroupNorm",
                 "Dropout", "Activation", "LeakyReLU", "softmax",
                 "log_softmax", "softmin", "SoftmaxOutput",
                 "softmax_cross_entropy", "UpSampling", "BilinearResize2D",
                 "FullyConnected", "convolution", "batch_norm", "ctc_loss"):
        assert callable(getattr(tmx.nd, name)), name


# -- op-level rules the SPECS cases do not reach ------------------------------

def _op_grads(pkg_nd, ag, fn, arrays, cots):
    args = [pkg_nd.array(a) for a in arrays]
    args[0].attach_grad()
    with ag.record():
        outs = fn(pkg_nd, *args)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        loss = None
        for o, c in zip(outs, cots):
            term = (o * pkg_nd.array(c)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [o.asnumpy() for o in outs], args[0].grad.asnumpy()


@pytest.mark.parametrize("case", ["bn_mean_var", "softmax_output_valid",
                                  "softmax_output_batch"])
def test_op_gradients_match_jax(case):
    """BatchNorm's gradient through its mean and variance outputs too
    (``_bn_train_core``'s cotangents), and SoftmaxOutput's own gradient,
    ``grad_scale * (p - onehot(y))`` masked and normalised, which ignores
    the incoming one."""
    rng = np.random.RandomState(len(case))
    if case == "bn_mean_var":
        arrays = [rng.standard_normal((4, 3, 5, 5)).astype(np.float32) * 2,
                  rng.uniform(0.5, 1.5, 3).astype(np.float32),
                  rng.uniform(-0.5, 0.5, 3).astype(np.float32),
                  np.zeros(3, np.float32), np.ones(3, np.float32)]

        def fn(F, x, g, b, mm, mv):
            return F.BatchNorm(x, g, b, mm, mv, fix_gamma=False,
                               output_mean_var=True, _is_training=True)
        shapes = [(4, 3, 5, 5), (3,), (3,)]
    else:
        label = rng.randint(0, 5, 6).astype(np.float32)
        label[1] = -1
        norm = case.split("_")[-1]
        arrays = [rng.standard_normal((6, 5)).astype(np.float32), label]

        def fn(F, x, y):
            return F.SoftmaxOutput(x, y, grad_scale=2.0, use_ignore=True,
                                   ignore_label=-1, normalization=norm)
        shapes = [(6, 5)]
    cots = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = _op_grads(nd, jag, fn, arrays, cots)
    with cpu():
        got = _op_grads(tnd, tag, fn, arrays, cots)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_dropout_shares_its_mask_along_axes():
    x = np.ones((4, 6, 8), np.float32)
    with cpu():
        tmx.random.seed(3)
        with tag.train_mode():
            out = tnd.Dropout(tnd.array(x), p=0.5, axes=(1,)).asnumpy()
    assert set(np.unique(out)) <= {0.0, 2.0}
    assert (out == out[:, :1, :]).all()          # one mask along axis 1
    assert 0 < (out == 0).mean() < 1
    with cpu():
        same = tnd.Dropout(tnd.array(x), p=0.5, axes=(1,)).asnumpy()
    np.testing.assert_array_equal(same, x)        # predict mode: identity
