"""The small imperative families of the port against the JAX package's, on
the CPU: the control flow (``foreach``, ``while_loop``, ``cond``), the
``mx.nd.linalg`` and ``mx.nd.contrib`` namespaces, the legacy output
heads (forward, and the gradient their backward injects), a ``CustomOp``
registered in both packages, the initializers, ``nd.from_numpy`` /
``nd.from_dlpack`` and ``engine.bulk`` / ``set_bulk_size``.  Values at
rtol 1e-4 / atol 1e-5, gradients at rtol 2e-3 / atol 2e-4; the random
initializers by their properties (threefry and Philox draw other
numbers)."""

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from test_operator import SPECS
from torch_one_thread import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, want, tol=FWD):
    for g, w in zip(*(v if isinstance(v, list) else [v]
                      for v in (_np(got), _np(want)))):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **tol)


def _both(fn):
    """``fn(nd)`` through the JAX package and through the port (on the
    host)."""
    want = fn(jnd)
    with tmx.cpu():
        got = fn(tnd)
    return got, want


# -- control flow ----------------------------------------------------------------

def test_foreach_matches_jax():
    rs = np.random.RandomState(0)
    data, s0 = rs.randn(5, 3).astype(np.float32), rs.randn(3).astype(
        np.float32)
    pair = rs.randn(5, 2).astype(np.float32)

    def body(x, states):
        return x * 2 + states[0], [states[0] + x, states[1] * 0.5]

    def run(nd):
        return nd.contrib.foreach(body, nd.array(data),
                                  [nd.array(s0), nd.array(s0)])

    (gout, gst), (wout, wst) = _both(run)
    _close(gout, wout)
    _close(list(gst), list(wst))

    def run_list(nd):     # a list of sequences, two outputs a step
        return nd.contrib.foreach(
            lambda xs, st: ([xs[0] * st[0], xs[1].sum() + st[0]],
                            [st[0] + 1]),
            [nd.array(data), nd.array(pair)], [nd.array(s0)])

    (gout, gst), (wout, wst) = _both(run_list)
    _close(list(gout), list(wout))
    _close(list(gst), list(wst))


def test_foreach_records_on_the_tape():
    with tmx.cpu():
        x = tnd.array(np.arange(6, dtype=np.float32).reshape(3, 2))
        x.attach_grad()
        with tag.record():
            outs, (acc,) = tnd.contrib.foreach(
                lambda v, st: (v * st[0], [st[0] + v]), x,
                [tnd.ones((2,))])
            total = outs.sum() + acc.sum()
        total.backward()
    # d/dx_i of sum_i x_i * (1 + sum_{j<i} x_j) + sum x
    xs = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = 1 + np.cumsum(xs, 0) - xs + xs[::-1].cumsum(0)[::-1] - xs + 1
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-6)


@pytest.mark.parametrize("max_iterations", [None, 3, 6])
def test_while_loop_matches_jax(max_iterations):
    s0 = np.array([0.5, -1.0, 2.0], np.float32)

    def run(nd):
        return nd.contrib.while_loop(
            cond=lambda i, s: i < 4,
            func=lambda i, s: ([s * i, i + 0], [i + 1, s + i]),
            loop_vars=[nd.array([0.0]), nd.array(s0)],
            max_iterations=max_iterations)

    (gout, gvars), (wout, wvars) = _both(run)
    _close(list(gvars), list(wvars))
    assert len(gout) == len(wout)
    if max_iterations is not None:
        for g, w in zip(gout, wout):
            assert g.shape == w.shape == (max_iterations,) + w.shape[1:]
        _close(list(gout), list(wout))
        assert not gout[0].asnumpy()[min(4, max_iterations):].any()


def test_while_loop_no_step_and_single_output():
    def run(nd):
        return nd.contrib.while_loop(
            cond=lambda i, s: i < 10, func=lambda i, s: (s * 3,
                                                         [i + 1, s + 1]),
            loop_vars=[nd.array([20.0]), nd.array([1.0, 2.0])],
            max_iterations=4)

    (gout, gvars), (wout, wvars) = _both(run)
    assert gout.shape == wout.shape == (4, 2)
    _close(gout, wout)
    _close(list(gvars), list(wvars))


@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_cond_matches_jax(flag):
    a = np.array([1.0, -2.0, 3.0], np.float32)

    def thunks(nd):
        x = nd.array(a)
        return nd.contrib.cond(nd.array([flag]), lambda: x * 2,
                               lambda: x - 1)

    def with_inputs(nd):
        return nd.contrib.cond(nd.array([flag]), lambda v: v * v,
                               lambda v: -v, inputs=[nd.array(a)])

    for fn in (thunks, with_inputs):
        got, want = _both(fn)
        _close(got, want)


# -- the namespaces -----------------------------------------------------------------

LINALG = ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
          "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
          "extracttrian", "maketrian", "inverse", "det", "slogdet", "svd")


def test_nd_linalg_names_match_jax():
    """``mx.nd.linalg`` has the JAX package's names, each the op
    ``linalg_<name>`` whose forward ``test_torch_operator.py`` holds
    against JAX; here each runs on that test's inputs and equals the
    op."""
    assert {n for n in dir(jnd.linalg) if not n.startswith("_")
            and callable(getattr(jnd.linalg, n))} == set(LINALG)
    for name in LINALG:
        spec = SPECS["linalg_" + name] if "linalg_" + name in SPECS \
            else SPECS[name]
        with tmx.cpu():
            args = [tnd.array(a) for a in spec.args]
            got = getattr(tnd.linalg, name)(*args, **spec.kwargs)
            want = getattr(tnd, "linalg_" + name)(*args, **spec.kwargs)
        for g, w in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (got, want))):
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_nd_contrib_names_match_jax():
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    for fn in (lambda nd: nd.contrib.div_sqrt_dim(nd.array(x)),
               lambda nd: nd.contrib.arange_like(nd.array(x)),
               lambda nd: nd.contrib.arange_like(nd.array(x), start=2.0,
                                                 step=0.5, axis=1),
               lambda nd: nd.contrib.arange_like(nd.array(x), repeat=2,
                                                 axis=2)):
        got, want = _both(fn)
        assert got.shape == want.shape
        _close(got, want)
    from mxnet_tpu_torch.ops.registry import all_ops

    exposed = {n.split("contrib_", 1)[1] for n in all_ops()
               if n.startswith(("_contrib_", "contrib_"))}
    assert exposed and all(callable(getattr(tnd.contrib, n))
                           for n in exposed)
    assert exposed <= set(dir(jnd.contrib))
    for name in ("foreach", "while_loop", "cond"):
        assert getattr(tnd.contrib, name) is getattr(tnd, name)


# -- the legacy output heads -----------------------------------------------------

HEADS = [
    ("LinearRegressionOutput", {"grad_scale": 0.5}, "real"),
    ("MAERegressionOutput", {}, "real"),
    ("LogisticRegressionOutput", {"grad_scale": 2.0}, "binary"),
    ("SVMOutput", {"margin": 0.5}, "class"),
    ("SVMOutput", {"use_linear": True, "regularization_coefficient": 0.3},
     "class"),
    ("MakeLoss", {}, None),
    ("MakeLoss", {"normalization": "batch", "grad_scale": 3.0}, None),
    ("MakeLoss", {"normalization": "valid", "valid_thresh": 0.5}, None),
]


@pytest.mark.parametrize("name,kw,label", HEADS)
def test_legacy_head_matches_jax(name, kw, label):
    rs = np.random.RandomState(len(name) + len(kw))
    data = rs.randn(4, 3).astype(np.float32)
    lab = {"real": rs.randn(4, 3), "binary": rs.randn(4, 3) > 0,
           "class": rs.randint(0, 3, 4), None: None}[label]
    head = rs.randn(4, 3).astype(np.float32)   # ignored by the backward

    def run(nd, ag):
        x = nd.array(data)
        x.attach_grad()
        args = [x] + ([] if lab is None else
                      [nd.array(np.asarray(lab, np.float32))])
        with ag.record():
            out = getattr(nd, name)(*args, **kw)
        out.backward(nd.array(head))
        return out.asnumpy(), x.grad.asnumpy()

    want = run(jnd, jag)
    with tmx.cpu():
        got = run(tnd, tag)
    _close(got[0], want[0])
    _close(got[1], want[1], GRAD)


def test_all_finite_matches_jax():
    ok = np.ones((2, 3), np.float32)
    bad = ok.copy()
    bad[1, 2] = np.inf
    for fn in (lambda nd: nd.all_finite(nd.array(ok)),
               lambda nd: nd.all_finite(nd.array(bad)),
               lambda nd: nd.multi_all_finite(nd.array(ok), nd.array(ok),
                                              num_arrays=2),
               lambda nd: nd.multi_all_finite(nd.array(ok), nd.array(bad),
                                              num_arrays=2)):
        got, want = _both(fn)
        assert got.dtype == want.dtype
        _close(got, want)


# -- CustomOp ---------------------------------------------------------------------

def _register_custom(pkg):
    class SigmoidMul(pkg.operator.CustomOp):
        """out = sigmoid(a) * b."""

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            s = 1.0 / (1.0 + (-a).exp())
            self.assign(out_data[0], req[0], s * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            s = 1.0 / (1.0 + (-a).exp())
            g = out_grad[0]
            self.assign(in_grad[0], req[0], g * b * s * (1.0 - s))
            self.assign(in_grad[1], req[1], g * s)

    @pkg.operator.register("sigmoid_mul_parity")
    class SigmoidMulProp(pkg.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, shapes, dtypes):
            return SigmoidMul()

    return SigmoidMulProp


JPROP, TPROP = _register_custom(mx), _register_custom(tmx)


def test_custom_op_matches_jax():
    rs = np.random.RandomState(2)
    a, b, g = (rs.randn(3, 4).astype(np.float32) for _ in range(3))

    def run(nd, ag):
        xa, xb = nd.array(a), nd.array(b)
        xa.attach_grad()
        xb.attach_grad()
        with ag.record():
            out = nd.Custom(xa, xb, op_type="sigmoid_mul_parity")
        out.backward(nd.array(g))
        return out.asnumpy(), xa.grad.asnumpy(), xb.grad.asnumpy()

    want = run(jnd, jag)
    with tmx.cpu():
        got = run(tnd, tag)
    _close(got[0], want[0])
    _close(got[1:], list(want[1:]), GRAD)
    assert tmx.operator.get("sigmoid_mul_parity") is TPROP
    with pytest.raises(tmx.MXNetError):
        with tmx.cpu():
            tnd.Custom(tnd.ones((2,)), op_type="not_registered")


# -- initializers -------------------------------------------------------------------

def _jax_fill(init, name, shape):
    arr = jnd.zeros(shape)
    init(mx.init.InitDesc(name), arr)
    return arr.asnumpy()


def _port_fill(init, name, shape, seed=0):
    t = torch.zeros(shape)
    init(name, t, torch.Generator().manual_seed(seed))
    return t.numpy()


def _arrays(pkg, params):
    """``Load``'s dict as the package's NDArrays (on the host)."""
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in params.items()}


def test_exact_initializers_match_jax():
    params = {"w_weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    cases = [
        (lambda m: m.init.LSTMBias(forget_bias=2.5), "l0_i2h_bias", (16,)),
        (lambda m: m.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
        (lambda m: m.init.Constant(0.25), "c_weight", (3, 2)),
        (lambda m: m.init.Load(_arrays(m, params),
                               default_init=m.init.Constant(7.0)),
         "w_weight", (2, 3)),
        (lambda m: m.init.Load(_arrays(m, params),
                               default_init=m.init.Constant(7.0)),
         "other_weight", (2, 2)),
        (lambda m: m.init.Mixed([".*bias", ".*"],
                                [m.init.LSTMBias(1.0),
                                 m.init.Constant(-0.5)]), "x_bias", (8,)),
        (lambda m: m.init.Mixed([".*bias", ".*"],
                                [m.init.LSTMBias(1.0),
                                 m.init.Constant(-0.5)]), "x_weight",
         (2, 2)),
    ]
    for make, name, shape in cases:
        want = _jax_fill(make(mx), name, shape)
        got = _port_fill(make(tmx), name, shape)
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError):
        _port_fill(tmx.init.Load(params), "w_weight", (3, 2))
    with pytest.raises(ValueError):
        _port_fill(tmx.init.Mixed(["a.*"], [tmx.init.Zero()]), "b", (2,))


def test_init_desc_and_dumps_round_trip():
    desc = tinit.InitDesc("q_weight", attrs={"__init__": "zeros"})
    t = torch.ones(2, 2)
    tinit.Normal(1.0)(desc, t, torch.Generator().manual_seed(0))
    assert not t.any() and desc.global_init is not None
    for make in (lambda m: m.init.Xavier("gaussian", "in", 2.0),
                 lambda m: m.init.MSRAPrelu("out", 0.1),
                 lambda m: m.init.Orthogonal(0.5, "normal"),
                 lambda m: m.init.LSTMBias(0.7),
                 lambda m: m.init.FusedRNN(m.init.Uniform(0.1), 4, 2,
                                           "lstm", True, 1.5)):
        s = make(tmx).dumps()
        assert json.loads(s) == json.loads(make(mx).dumps())
        klass, kw = json.loads(s)
        again = tinit.create(klass, **kw)
        assert again.dumps() == s


def test_random_initializers_by_property():
    gen = torch.Generator().manual_seed(0)
    w = torch.zeros(64, 256)
    tinit.Orthogonal(scale=1.5)("o_weight", w, gen)
    np.testing.assert_allclose((w @ w.T).numpy(), 2.25 * np.eye(64),
                               atol=1e-4)
    w = torch.zeros(128, 32, 3, 3)
    tinit.Orthogonal(rand_type="normal")("o_weight", w, gen)
    flat = w.reshape(128, -1)
    np.testing.assert_allclose((flat @ flat.T).numpy(),
                               1.414 ** 2 * np.eye(128), atol=1e-4)
    w = torch.zeros(400, 300)
    tinit.MSRAPrelu(slope=0.25)("m_weight", w, gen)
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / 350.0)
    assert abs(w.std().item() / want - 1) < 0.02 and \
        abs(w.mean().item()) < 0.01 * want * 10
    w = torch.zeros(400, 300)
    tinit.Xavier(magnitude=3)("x_weight", w, gen)
    bound = np.sqrt(3.0 / 350.0)
    assert w.abs().max().item() <= bound
    assert abs(w.std().item() / (bound / np.sqrt(3)) - 1) < 0.02


def test_fused_rnn_initializer():
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    H, layers = 4, 2
    n = rnn_param_size("lstm", 3, H, layers, bidirectional=True)
    init = tinit.FusedRNN(tinit.Uniform(0.1).dumps(), H, layers, "lstm",
                          True, forget_bias=1.5)
    t = torch.zeros(n)
    # the packed vector's own init, as a Variable(init=FusedRNN(...))
    tinit.Zero()(tinit.InitDesc("rnn_parameters", {"__init__": init}), t,
                 torch.Generator().manual_seed(0))
    # every (bx, bh) pair: bx's forget quarter 1.5, bh's 0
    biases = t[n - layers * 2 * 2 * 4 * H:].reshape(layers * 2, 2, 4, H)
    assert (biases[:, 0, 1] == 1.5).all() and (biases[:, 1, 1] == 0).all()
    rest = torch.cat([t[:n - layers * 2 * 2 * 4 * H],
                      biases[:, :, [0, 2, 3]].reshape(-1)])
    assert rest.abs().max() <= 0.1 and rest.std() > 0.03
    jt = jnd.zeros((n,))
    jinit = mx.init.FusedRNN(mx.init.Uniform(0.1), H, layers, "lstm", True,
                             1.5)
    mx.init.Zero()(mx.init.InitDesc("rnn_parameters", {"__init__": jinit}),
                   jt)
    jb = jt.asnumpy()[n - layers * 2 * 2 * 4 * H:].reshape(layers * 2, 2,
                                                            4, H)
    np.testing.assert_array_equal(biases[:, :, 1].numpy(), jb[:, :, 1])


def test_lstm_bias_through_a_layer():
    """``i2h_bias_initializer=LSTMBias`` on a fused layer: each layer's
    forget quarter, in both packages."""
    jnet = mx.gluon.rnn.LSTM(3, num_layers=2, input_size=2,
                             i2h_bias_initializer=mx.init.LSTMBias(2.0))
    jnet.initialize()
    with tmx.cpu():
        tnet = tmx.gluon.rnn.LSTM(3, num_layers=2, input_size=2,
                                  i2h_bias_initializer=tmx.init.LSTMBias(
                                      2.0))
        tnet.initialize()
    for i in range(2):
        want = getattr(jnet, f"l{i}_i2h_bias").data().asnumpy()
        got = getattr(tnet, f"l{i}_i2h_bias").data().asnumpy()
        np.testing.assert_array_equal(got, want)
        assert (got[3:6] == 2.0).all()


# -- from_numpy, from_dlpack, the engine's bulk ---------------------------------

def test_from_numpy_and_from_dlpack_match_jax():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    for fn in (lambda nd: nd.from_numpy(a),
               lambda nd: nd.from_numpy(a.astype(np.int32), zero_copy=True),
               lambda nd: nd.from_dlpack(a.astype(np.float32))):
        got, want = _both(fn)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    t = torch.arange(6, dtype=torch.float32)
    shared = tnd.from_dlpack(torch.utils.dlpack.to_dlpack(t))
    t[0] = 42.0
    assert shared.asnumpy()[0] == 42.0 and str(shared.context) == "cpu(0)"


def test_engine_bulk_and_bulk_size_match_jax():
    from mxnet_tpu import engine as jengine
    from mxnet_tpu_torch import engine as tengine

    for eng in (jengine, tengine):
        prev = eng.set_bulk_size(30)
        assert prev == 15
        assert eng.set_bulk_size(prev) == 30
        with eng.bulk(10):
            pass
    with tmx.cpu(), tengine.bulk(4):
        np.testing.assert_array_equal((tnd.ones((2,)) * 3).asnumpy(), 3.0)
