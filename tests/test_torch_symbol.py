"""The port's symbolic path against the JAX package's, on the CPU.

Graphs (``tests/test_symbol_module.py:24-140,284-395``): composition,
``list_*``, ``attr_dict`` under ``AttrScope``, ``infer_shape`` and
``infer_type``, ``Group``, ``mx.sym.contrib``; each graph built in one
package is written with ``tojson`` and read by the other, which must see
the same graph and evaluate it to the same values.  Files: the
``-symbol.json``/``.params`` pair of an MLP with BatchNorm and Dropout, a
convnet, ResNet-18, ``gpt_tiny``, ``bert_tiny`` with decoder and pooler
(both trunk layouts) and an SSD of small width, exported by each package
and imported by the other's ``SymbolBlock``, against the exporter's own
output.  The Executor's forward and backward under ``write`` and
``add``, ``partition``/``optimize_for`` on ``tests/test_subgraph.py``'s
graphs (the same regions), the Monitor's statistics, and the public
names of the new modules.

Tolerances are the reference tests' own: outputs rtol 2e-4 / atol 2e-5
(atol 1e-5 for ResNet-18 and the SSD, rtol/atol 1e-4 for the
transformers), gradients rtol 2e-3 / atol 2e-4.
"""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.subgraph as jsg
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.subgraph as tsg
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _on_host():
    with cpu():
        yield


# -- graphs -------------------------------------------------------------------

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


def _arith(m):
    a, b = m.sym.Variable("a"), m.sym.Variable("b")
    return 2 * a + b / a - (a ** 2) * 0.5


def _group(m):
    a = m.sym.Variable("a")
    return m.sym.Group([m.sym.relu(a, name="r"), m.sym.sigmoid(a, name="s")])


def _scoped(m):
    x = m.sym.var("data")
    with m.AttrScope(ctx_group="stage1", lr_mult="0.1"):
        w = m.sym.var("w")
        h = m.sym.FullyConnected(x, w, None, num_hidden=3, no_bias=True,
                                 name="fc")
        with m.AttrScope(ctx_group="stage2"):
            h = m.sym.exp(h, name="e")
    return m.sym.log(h + 2.0, name="lg")


def _convbn(m):
    x = m.sym.var("data")
    c = m.sym.Convolution(x, m.sym.var("c_weight"), None, kernel=(3, 3),
                          num_filter=4, pad=(1, 1), no_bias=True, name="c")
    bn = m.sym.BatchNorm(c, m.sym.var("g"), m.sym.var("b"), m.sym.var("mm"),
                         m.sym.var("mv"), fix_gamma=False,
                         _is_training=False, name="bn")
    p = m.sym.Pooling(m.sym.relu(bn), kernel=(2, 2), stride=(2, 2),
                      pool_type="max", name="pool")
    return m.sym.FullyConnected(m.sym.Flatten(p), m.sym.var("o_weight"),
                                m.sym.var("o_bias"), num_hidden=5, name="o")


#: graph makers and the shapes their inference starts from
GRAPHS = {
    "mlp": (_mlp, dict(data=(8, 10))),
    "arith": (_arith, dict(a=(3, 4), b=(3, 4))),
    "group": (_group, dict(a=(2, 5))),
    "scoped": (_scoped, dict(data=(4, 6), w=(3, 6))),
    "convbn": (_convbn, dict(data=(2, 3, 8, 8))),
}


def _feed(sym, shapes, seed):
    """numpy values for every argument of ``sym``, shaped by its
    ``infer_shape`` from ``shapes``."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    feed = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "softmax_label":
            feed[name] = rng.randint(0, 4, shape).astype(np.float32)
        elif name in ("mv",):
            feed[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name in ("a",):
            feed[name] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            feed[name] = rng.randn(*shape).astype(np.float32)
    return feed


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _graph_view(sym):
    return (sym.list_arguments(), sym.list_outputs(),
            sym.list_auxiliary_states(), sym.list_inputs(),
            sym.attr_dict())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_crosses_packages(name):
    """A graph built in either package reads back in the other as the same
    graph (names, outputs, attributes, inferred shapes and types) and
    evaluates to the same values."""
    make, partial = GRAPHS[name]
    jsym, tsym = make(mx), make(tmx)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    feed = _feed(tsym, partial, 0)
    for src, dst, pkg in ((jsym, tmx.sym.fromjson(jsym.tojson()), tmx),
                          (tsym, mx.sym.fromjson(tsym.tojson()), mx)):
        assert _graph_view(dst) == _graph_view(src)
        js = src if pkg is tmx else dst        # the JAX package's copy
        ts = dst if pkg is tmx else src
        ta, to, tx = ts.infer_shape(**partial)
        assert tx == [] and len(to) == len(ts.list_outputs())
        if not isinstance(js, mx.sym.Group):    # the JAX package's raises
            ja, jo, jx = js.infer_shape(**partial)
            assert (ta, to, tx) == (ja, jo, jx)
        assert ts.infer_type()[0] == js.infer_type()[0]
        assert len(ts.infer_type()[1]) == len(ts.list_outputs())
        want = _as_list(js.eval_raw(**feed))
        got = _as_list(ts.eval_raw(**{k: torch.from_numpy(v)
                                      for k, v in feed.items()}))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)


def test_symbol_attr_scope_and_json_attrs(tmp_path):
    """AttrScope attaches to the nodes made inside (inner scopes override
    outer keys), survives a save/load, and a load inside an open scope
    does not stamp it onto the loaded nodes; a dunder attribute of the
    reference's format reaches the optimizer's multipliers."""
    s = _scoped(tmx)
    a = s.attr_dict()
    assert a["w"] == {"ctx_group": "stage1", "lr_mult": "0.1"}
    assert a["fc"] == {"ctx_group": "stage1", "lr_mult": "0.1"}
    assert a["e"]["ctx_group"] == "stage2" and "lg" not in a
    f = str(tmp_path / "s-symbol.json")
    s.save(f)
    with tmx.AttrScope(lr_mult="9.9"):
        back = tmx.sym.load(f)
    assert back.attr_dict() == a
    doc = json.loads(s.tojson())
    w = next(n for n in doc["nodes"] if n["name"] == "w")
    w["attrs"]["__lr_mult__"] = "0.25"
    del w["attrs"]["lr_mult"]
    opt = tmx.optimizer.create("sgd", sym=tmx.sym.fromjson(json.dumps(doc)),
                               param_idx2name={0: "w"})
    assert opt.lr_mult["w"] == 0.25
    with pytest.raises(ValueError):
        tmx.sym.var("x", lr=1.0)
    with pytest.raises(ValueError):
        tmx.AttrScope(lr_mult=0.1)


def test_symbol_indexing_scalars_and_nulls():
    """Array indexing becomes a ``_sym_index`` node, positional scalars
    constants, interior Nones null slots: the same JSON either way."""
    for m in (mx, tmx):
        x = m.sym.var("x")
        y = m.sym.clip(x[:, 1:3], 0.0, 6.0) * 3
        doc = json.loads(y.tojson())
        ops = [n["op"] for n in doc["nodes"]]
        assert ops.count("_sym_index") == 1 and "clip" in ops
        assert sum("__scalar__" in n["attrs"] for n in doc["nodes"]) == 3
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = np.asarray(mx.sym.fromjson(y.tojson()).eval_raw(x=v))
    got = y.eval_raw(x=torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_symbol_contrib_namespace():
    """``mx.sym.contrib`` builds the contrib ops (box_nms over rows of
    [id, score, x1, y1, x2, y2])."""
    dets = np.array([[[0, 0.9, 0.1, 0.1, 0.5, 0.5],
                      [0, 0.8, 0.12, 0.12, 0.52, 0.52],
                      [1, 0.7, 0.6, 0.6, 0.9, 0.9]]], np.float32)
    outs = []
    for m in (mx, tmx):
        d = m.sym.Variable("dets")
        outs.append(m.sym.contrib.box_nms(d, overlap_thresh=0.5,
                                          valid_thresh=0.01))
    want = np.asarray(outs[0].eval_raw(dets=dets))
    got = outs[1].eval_raw(dets=torch.from_numpy(dets)).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    assert hasattr(tmx.sym.contrib, "ROIAlign")
    assert hasattr(tmx.sym, "MultiBoxPrior")


# -- the deploy format in both directions -------------------------------------

def _dense_bn(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(16, activation="relu"), g.nn.BatchNorm(),
            g.nn.Dropout(0.5), g.nn.Dense(4))
    return net


def _convnet(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(8, 3, padding=1, use_bias=False), g.nn.BatchNorm(),
            g.nn.Activation("relu"), g.nn.MaxPool2D(2), g.nn.Flatten(),
            g.nn.Dense(5))
    return net


def _resnet18(g):
    return g.model_zoo.vision.resnet18_v1(classes=10)


def _ssd(g):
    return g.model_zoo.SSD(num_classes=2, base_channels=(8, 16, 32))


def _gpt(g, **kw):
    return g.model_zoo.gpt.gpt_tiny(**kw)


def _bert(g, **kw):
    return g.model_zoo.bert.bert_tiny(use_decoder=True, use_pooler=True,
                                      **kw)


def _bert_scan(g, **kw):
    return _bert(g, scan_layers=True, **kw)


def _floats(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.float32)


MODELS = {
    "dense_bn": (_dense_bn, lambda: _floats((3, 8), 0), OUT_TOL),
    "convnet": (_convnet, lambda: _floats((2, 3, 16, 16), 1), OUT_TOL),
    "resnet18": (_resnet18, lambda: _floats((2, 3, 32, 32), 2),
                 dict(rtol=0, atol=1e-5)),
    "gpt_tiny": (_gpt, lambda: _ids((2, 10), 128, 3),
                 dict(rtol=1e-4, atol=1e-4)),
    "bert_tiny": (_bert, lambda: _ids((2, 12), 100, 4),
                  dict(rtol=1e-4, atol=1e-4)),
    "bert_tiny_scan": (_bert_scan, lambda: _ids((2, 12), 100, 5),
                       dict(rtol=1e-4, atol=1e-4)),
    "ssd": (_ssd, lambda: _floats((1, 3, 64, 64), 6),
            dict(rtol=0, atol=1e-5)),
}

_ZOO_LM = (_gpt, _bert, _bert_scan)


def _jax_export(make, x, prefix):
    """The JAX package's net of ``make`` (Xavier from a seed), hybridized,
    run once in predict mode and exported; its outputs."""
    mx.random.seed(11)
    net = make(jgluon)
    net.initialize(init=mx.init.Xavier())
    net.hybridize()
    out = _as_list(net(jnd.array(x)))
    net.export(prefix)
    return [np.asarray(o.asnumpy()) for o in out]


def _port_export(make, x, prefix):
    """The port's net of ``make`` (Xavier from a torch generator),
    hybridized, run once in predict mode and exported; its outputs."""
    gen = torch.Generator().manual_seed(12)
    net = make(tgluon, device=cpu()) if make in _ZOO_LM else make(tgluon)
    net.initialize(init=tinit.Xavier(), generator=gen)
    net.hybridize()
    with torch.no_grad():
        out = _as_list(net(tnd.array(x)))
    net.export(prefix)
    return [o.asnumpy() for o in out]


def _jax_import(prefix, x):
    """The JAX package's ``SymbolBlock.imports`` of the pair, its graph
    evaluated as one jitted program on the block's parameters."""
    sb = jgluon.SymbolBlock.imports(f"{prefix}-symbol.json", ["data"],
                                    f"{prefix}-0000.params")
    params = {n: p.data()._data for n, p in sb.collect_params().items()}
    fn = jax.jit(lambda p, d: sb._outputs_sym.eval_raw(data=d, **p))
    return [np.asarray(o) for o in _as_list(fn(params, jnp_array(x)))]


def jnp_array(x):
    return jax.numpy.asarray(x)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_exports_cross_packages(name, tmp_path):
    """Each package's export imports in the other's SymbolBlock and
    reproduces the exporter's outputs."""
    make, data, tol = MODELS[name]
    x = data()
    want = _jax_export(make, x, str(tmp_path / "j"))
    sb = tgluon.SymbolBlock.imports(str(tmp_path / "j-symbol.json"),
                                    ["data"], str(tmp_path / "j-0000.params"))
    got = _as_list(sb(tnd.array(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w, **tol)
    want = _port_export(make, x, str(tmp_path / "t"))
    got = _jax_import(str(tmp_path / "t"), x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


def test_port_export_roundtrip_and_training_mode(tmp_path):
    """The port's own pair: a SymbolBlock equal bitwise to the block in
    predict mode; under ``autograd.record()`` its BatchNorm normalises
    with the batch and moves its moving statistics as the block's own
    training forward does, and gradients reach its parameters."""
    x = tnd.array(_floats((4, 3, 16, 16), 7))
    net = _convnet(tgluon)
    net.initialize(init=tinit.Xavier(),
                   generator=torch.Generator().manual_seed(1))
    net.hybridize()
    ref = net(x)
    net.export(str(tmp_path / "c"))
    sb = tgluon.SymbolBlock.imports(str(tmp_path / "c-symbol.json"), "data",
                                    str(tmp_path / "c-0000.params"))
    np.testing.assert_array_equal(sb(x).asnumpy(), ref.asnumpy())
    with tmx.autograd.record():
        want = net(x)
        got = sb(x)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **OUT_TOL)
    bn = [k for k in net.collect_params() if k.endswith("running_var")][0]
    np.testing.assert_allclose(sb.collect_params()[bn].data().asnumpy(),
                               net.collect_params()[bn].data().asnumpy(),
                               **OUT_TOL)
    got.backward()
    w = [k for k in sb.collect_params() if k.endswith("weight")][0]
    assert float(np.abs(sb.collect_params()[w].grad().asnumpy()).sum()) > 0


# -- executor -----------------------------------------------------------------

def _two_layer(m):
    x = m.sym.var("data")
    h = m.sym.Activation(m.sym.FullyConnected(
        x, m.sym.var("w1"), m.sym.var("b1"), num_hidden=6), act_type="tanh")
    return m.sym.FullyConnected(h, m.sym.var("w2"), m.sym.var("b2"),
                                num_hidden=3)


@pytest.mark.parametrize("make,req", [(_two_layer, "write"),
                                      (_two_layer, "add"),
                                      (_mlp, "write")])
def test_executor_matches_jax(make, req):
    """forward and backward (head gradients given) against the JAX
    Executor; ``add`` accumulates two passes."""
    jsym = make(mx)
    tsym = tmx.sym.fromjson(jsym.tojson())
    shapes = dict(data=(5, 4)) if make is _two_layer else \
        dict(data=(8, 10), softmax_label=(8,))
    feed = _feed(jsym, shapes, 3)
    og = np.random.RandomState(4).randn(
        5 if make is _two_layer else 8, 3 if make is _two_layer else 4) \
        .astype(np.float32)
    reqs = {n: ("null" if n in ("data", "softmax_label") else req)
            for n in jsym.list_arguments()}
    jexe = jsym.simple_bind(grad_req=reqs, **shapes)
    texe = tsym.simple_bind(grad_req=reqs, **shapes)
    jexe.copy_params_from({k: jnd.array(v) for k, v in feed.items()})
    texe.copy_params_from({k: tnd.array(v) for k, v in feed.items()})
    for _ in range(2 if req == "add" else 1):
        jout = jexe.forward(is_train=True)
        tout = texe.forward(is_train=True)
        jexe.backward(out_grads=jnd.array(og))
        texe.backward(out_grads=tnd.array(og))
    np.testing.assert_allclose(tout[0].asnumpy(), jout[0].asnumpy(),
                               **OUT_TOL)
    assert sorted(texe.grad_dict) == sorted(jexe.grad_dict)
    for n in jexe.grad_dict:
        np.testing.assert_allclose(texe.grad_dict[n].asnumpy(),
                                   jexe.grad_dict[n].asnumpy(), **GRAD_TOL,
                                   err_msg=n)


def test_executor_predict_then_backward_and_reshape():
    """A backward after a predict-mode forward runs the forward again,
    recorded; ``reshape`` keeps the parameter arrays (shared storage)."""
    sym = _two_layer(tmx)
    exe = sym.simple_bind(data=(5, 4), grad_req={"w1": "write",
                                                 "b1": "write",
                                                 "w2": "write",
                                                 "b2": "write"})
    feed = _feed(_two_layer(mx), dict(data=(5, 4)), 5)
    exe.copy_params_from({k: tnd.array(v) for k, v in feed.items()})
    exe.forward(is_train=False)
    exe.backward()
    g1 = exe.grad_dict["w1"].asnumpy()
    exe.forward(is_train=True)
    exe.backward()
    np.testing.assert_array_equal(exe.grad_dict["w1"].asnumpy(), g1)
    small = exe.reshape(data=(2, 4))
    assert small.arg_dict["w1"] is exe.arg_dict["w1"]
    assert small.forward()[0].shape == (2, 3)


# -- partitioning -------------------------------------------------------------

class _NoRelu:
    min_size = 1

    def op_filter(self, op, attrs):
        return op not in ("Activation", "relu") and \
            self._base.op_filter(op, attrs)


def _props():
    jp = type("JNoRelu", (_NoRelu, jsg.SubgraphProperty),
              {"_base": jsg.XLASubgraphProperty()})()
    tp = type("TNoRelu", (_NoRelu, tsg.SubgraphProperty),
              {"_base": tsg.XLASubgraphProperty()})()
    jsg.register_subgraph_property("_port_norelu", jp)
    tsg.register_subgraph_property("_port_norelu", tp)


def _whole(m):
    a, b = m.sym.Variable("a"), m.sym.Variable("b")
    return m.sym.broadcast_mul(m.sym.relu(a + b), a)


def _bn_stats(m):
    bn = m.sym.BatchNorm(m.sym.Variable("data"), m.sym.Variable("g"),
                         m.sym.Variable("be"), m.sym.Variable("mm"),
                         m.sym.Variable("mv"), output_mean_var=True,
                         fix_gamma=False, _is_training=True)
    return m.sym.broadcast_add(m.sym.relu(bn[0]),
                               m.sym.Reshape(bn[1], shape=(1, -1)))


def _split(m):
    a = m.sym.Variable("a")
    y = m.sym.relu(m.sym.broadcast_mul(a + a, a))
    return m.sym.broadcast_add(m.sym.relu(y + a), a)


def _no_cycle(m):
    a, b = m.sym.Variable("a"), m.sym.Variable("b")
    X = m.sym.broadcast_mul(a, a)
    Q = m.sym.broadcast_mul(b, b)
    return m.sym.broadcast_add(m.sym.broadcast_add(m.sym.relu(X), Q),
                               m.sym.broadcast_add(X, Q))


def _regions(p):
    return sorted(tuple(sorted(m.name for m in n._attr_dict["__members__"]))
                  for n in p._topo() if n.op == "_subgraph_exec")


@pytest.mark.parametrize("make,backend,shapes", [
    (_whole, "XLA", dict(a=(3, 4), b=(3, 4))),
    (_bn_stats, "XLA", dict(data=(4, 3))),
    (_split, "_port_norelu", dict(a=(2, 3))),
    (_no_cycle, "_port_norelu", dict(a=(2, 2), b=(2, 2))),
])
def test_partition_matches_jax(make, backend, shapes):
    """The same regions as the JAX ``partition`` (node names from one
    JSON), the same outputs, and the unknown-backend error."""
    _props()
    jsym = make(mx)
    tsym = tmx.sym.fromjson(jsym.tojson())
    jp, tp = jsym.optimize_for(backend), tsym.optimize_for(backend)
    assert _regions(tp) == _regions(jp)
    assert sorted(n.op for n in tp._topo() if n.op) == \
        sorted(n.op for n in jp._topo() if n.op)
    feed = _feed(jsym, shapes, 8)
    if "mv" in feed:
        feed["mv"] = np.abs(feed["mv"]) + 0.5
    want = np.asarray(jp.eval_raw(**feed))
    got = tp.eval_raw(**{k: torch.from_numpy(v) for k, v in feed.items()})
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(
        got.numpy(), tsym.eval_raw(**{k: torch.from_numpy(v)
                                      for k, v in feed.items()}).numpy(),
        rtol=0, atol=0)
    with pytest.raises(tmx.MXNetError, match="backend"):
        tsym.optimize_for("no_such_backend")
    assert "XLA" in tsg.list_backends()


def test_partition_random_and_mode_members():
    """A region's random member draws from the generator scope and
    follows the mode: train drops, predict is the identity."""
    a = tmx.sym.Variable("a")
    p = tmx.sym.broadcast_mul(tmx.sym.Dropout(a + a, p=0.5), a) \
        .optimize_for("XLA")
    av = torch.ones(4, 64)
    with tmx.autograd.train_mode():
        assert (p.eval_raw(a=av) == 0).any()
    with tmx.autograd.predict_mode():
        np.testing.assert_array_equal(p.eval_raw(a=av).numpy(),
                                      np.full((4, 64), 2.0, np.float32))


def test_hybridblock_optimize_for_matches_jax():
    """``HybridBlock.optimize_for`` of a two-input block against the JAX
    package's, the same weights in both."""
    def make(g, m):
        class TwoIn(g.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = g.nn.Dense(4, in_units=3)

            def hybrid_forward(self, F, a, b):
                return self.fc(a) + self.fc(b) * 2.0
        return TwoIn()

    rs = np.random.RandomState(9)
    a, b = (rs.randn(2, 3).astype(np.float32) for _ in range(2))
    w, bias = rs.randn(4, 3).astype(np.float32), rs.randn(4) \
        .astype(np.float32)
    outs = []
    for g, m, nd in ((jgluon, mx, jnd), (tgluon, tmx, tnd)):
        net = make(g, m)
        net.initialize()
        net.fc.weight.set_data(nd.array(w))
        net.fc.bias.set_data(nd.array(bias))
        sb = net.optimize_for(nd.array(a), "XLA", nd.array(b))
        assert "_subgraph_exec" in [n.op for n in sb._outputs_sym._topo()]
        outs.append(sb(nd.array(a), nd.array(b)).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **OUT_TOL)


# -- monitor ------------------------------------------------------------------

def test_monitor_stats_match_jax():
    """Monitor statistics (mean |x| and the non-finite share) of an
    executor's forward, node for node, against the JAX package's."""
    jsym = _mlp(mx)
    tsym = tmx.sym.fromjson(jsym.tojson())
    shapes = dict(data=(8, 10), softmax_label=(8,))
    feed = _feed(jsym, shapes, 10)
    feed["data"][0, 0] = np.inf
    res = []
    for m, sym, nd in ((mx, jsym, jnd), (tmx, tsym, tnd)):
        got = []
        for stat in (None, m.monitor.nonfinite_fraction):
            mon = m.monitor.Monitor(1, stat_func=stat, pattern=".*fc.*",
                                    sort=True)
            exe = sym.simple_bind(**shapes)
            exe.copy_params_from({k: nd.array(v) for k, v in feed.items()})
            mon.install(exe)
            mon.tic()
            exe.forward(is_train=True)
            got += [(n, float(s.asnumpy())) for _, n, s in mon.toc()]
        res.append(got)
    assert [n for n, _ in res[1]] == [n for n, _ in res[0]]
    assert [n for n, _ in res[1]][:2] == ["fc1_output", "fc2_output"]
    np.testing.assert_allclose([v for _, v in res[1]],
                               [v for _, v in res[0]], **OUT_TOL)


# -- public names -------------------------------------------------------------

#: JAX names with no counterpart in the port, and why
LEFT_OUT = {}


@pytest.mark.parametrize("module", ["symbol", "symbol.contrib",
                                    "symbol.executor", "module", "model",
                                    "attribute", "subgraph", "monitor",
                                    "visualization"])
def test_public_names_of_symbolic_modules(module):
    """Every public top-level name of the JAX module has a counterpart in
    the port's, less those named in ``LEFT_OUT`` with their reason; the
    package aliases point at the modules."""
    jm = importlib.import_module(f"mxnet_tpu.{module}")
    tm = importlib.import_module(f"mxnet_tpu_torch.{module}")
    left = LEFT_OUT.get(module, {})
    names = {n for n in dir(jm) if not n.startswith("_")
             and not isinstance(getattr(jm, n), type(json))}
    names -= {"annotations"}
    missing = sorted(n for n in names if not hasattr(tm, n)
                     and n not in left)
    assert not missing, missing
    assert all(not hasattr(tm, n) for n in left)
    for alias, target in (("sym", "symbol"), ("mod", "module"),
                          ("viz", "visualization"), ("mon", "monitor")):
        assert getattr(tmx, alias) is getattr(tmx, target)
    assert tmx.AttrScope is tmx.attribute.AttrScope
    assert tmx.amp.convert_model
    with pytest.raises(NotImplementedError):
        tmx.autograd.get_symbol(None)
