"""int8 quantization in the PyTorch port against the JAX package.

The six quantization ops on the same numpy inputs (int outputs bitwise,
f32 outputs within 1 ulp), among them sums far past the int8 and 2^24
ranges; the KL threshold search on the same histograms; ``quantize_model``
over one graph carried from one package to the other by its JSON, with
excluded layers and a convolution without bias; and ``quantize_net`` in
``naive`` and ``entropy`` mode over the JAX tests' nets (a conv net,
``resnet18_v1`` at 32x32, ``gpt_tiny``), the weights carried across:
int8 codes bitwise, calibration ranges bitwise where the float ops before
them are (else within a few ulps), outputs within a stated tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import quantization as jqz

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.contrib import quantization as tqz
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

jq = importlib.import_module("mxnet_tpu.ops.quantization")
tq = importlib.import_module("mxnet_tpu_torch.ops.quantization")

#: a quantized net's output, the port's against the JAX package's, relative
#: to the output's largest magnitude.  Both run the same int8 arithmetic
#: on the same codes; a float op before a quantizer (a convolution, an
#: attention) may round its last bit otherwise and move one code by one.
QNET_TOL = 1e-3
#: calibration ranges at points whose float inputs the two packages compute
#: in other summation orders: a few f32 ulps (the max of an activation one
#: ulp apart, the KL threshold over a histogram of range that max);
#: ``python tests/test_torch_quantization.py`` prints them a point
RANGE_RTOL = 1e-6


def _codes(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _both(fn_name, args, kwargs):
    """The op of both packages on the same numpy arguments: (port outputs,
    JAX outputs) as lists of numpy arrays."""
    jout = getattr(jq, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a for a in args], **kwargs)
    tout = getattr(tq, fn_name)(*[torch.from_numpy(a)
                                   if isinstance(a, np.ndarray) else a
                                   for a in args], **kwargs)
    jout = list(jout) if isinstance(jout, tuple) else [jout]
    tout = list(tout) if isinstance(tout, tuple) else [tout]
    return ([t.numpy() for t in tout], [np.asarray(j) for j in jout])


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                           g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)


def _r(v):
    return np.array([v], np.float32)


def _cases():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 6, 5).astype(np.float32)
    acc = rs.randint(-2 ** 30, 2 ** 30, (5, 7)).astype(np.int32)
    lims = (_r(-0.7), _r(0.9), _r(-0.02), _r(0.03), _r(-0.5), _r(0.4))
    return {
        "quantize": ("quantize", (x, _r(-1.3), _r(2.1)), {}),
        "quantize_scalar_range": ("quantize", (x, -0.25, 0.5), {}),
        "quantize_v2_own_range": ("quantize_v2", (x,), {}),
        "quantize_v2_calibrated": ("quantize_v2", (x,),
                                   {"min_calib_range": -1.7,
                                    "max_calib_range": 1.1}),
        "dequantize_int8": ("dequantize", (_codes(rs, 3, 4), _r(-2.0),
                                           _r(1.5)), {}),
        "dequantize_int32": ("dequantize", (acc, _r(-3.3), _r(3.3)), {}),
        "requantize": ("requantize", (acc, _r(-5.0), _r(5.0)), {}),
        "requantize_calibrated": ("requantize", (acc, _r(-5.0), _r(5.0)),
                                  {"min_calib_range": -2e-3,
                                   "max_calib_range": 3e-3}),
        "fc_bias": ("quantized_fully_connected",
                    (_codes(rs, 5, 12), _codes(rs, 9, 12), _codes(rs, 9))
                    + lims, {"num_hidden": 9}),
        "fc_no_bias_flatten": ("quantized_fully_connected",
                               (_codes(rs, 3, 2, 4, 3), _codes(rs, 6, 24),
                                None) + lims[:4],
                               {"num_hidden": 6, "no_bias": True}),
        "fc_3d_no_flatten": ("quantized_fully_connected",
                             (_codes(rs, 2, 5, 8), _codes(rs, 4, 8),
                              _codes(rs, 4)) + lims,
                             {"num_hidden": 4, "flatten": False}),
        "conv_3x3": ("quantized_conv",
                     (_codes(rs, 2, 3, 9, 9), _codes(rs, 5, 3, 3, 3),
                      _codes(rs, 5)) + lims,
                     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5}),
        "conv_7x7_stride2_k147": ("quantized_conv",
                                  (_codes(rs, 2, 3, 15, 15),
                                   _codes(rs, 4, 3, 7, 7), None) + lims[:4],
                                  {"kernel": (7, 7), "stride": (2, 2),
                                   "pad": (3, 3), "num_filter": 4,
                                   "no_bias": True}),
        "conv_1x1_stride2": ("quantized_conv",
                             (_codes(rs, 2, 6, 8, 8), _codes(rs, 3, 6, 1, 1),
                              _codes(rs, 3)) + lims,
                             {"kernel": (1, 1), "stride": (2, 2),
                              "num_filter": 3}),
        "conv_grouped": ("quantized_conv",
                         (_codes(rs, 1, 4, 6, 6), _codes(rs, 6, 2, 3, 3),
                          None) + lims[:4],
                         {"kernel": (3, 3), "num_group": 2, "num_filter": 6,
                          "no_bias": True}),
        "conv_1d": ("quantized_conv",
                    (_codes(rs, 2, 3, 11), _codes(rs, 4, 3, 3), _codes(rs, 4))
                    + lims, {"kernel": (3,), "pad": (1,), "num_filter": 4}),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    name, args, kwargs = CASES[case]
    got, want = _both(name, args, kwargs)
    _same(got, want)


@pytest.mark.parametrize("op", ["fc", "conv"])
def test_int32_sums_past_int8_and_2_24_are_exact(op):
    """Sums of products that leave the int8 range at once and the exact
    f32 integers (2^24) after a few hundred terms: torch's own int8
    convolution would wrap, an f32 product would round."""
    rs = np.random.RandomState(1)
    if op == "fc":
        data = np.full((3, 4096), 127, np.int8)
        data[1] = -127
        data[2] = rs.randint(100, 128, 4096)
        weight = np.full((8, 4096), 127, np.int8)
        weight[3] = rs.randint(-127, 128, 4096)
        args = (data, weight, None, _r(-1.0), _r(1.0), _r(-1.0), _r(1.0))
        got, want = _both("quantized_fully_connected", args,
                          {"num_hidden": 8, "no_bias": True})
        exact = data.astype(np.int64) @ weight.astype(np.int64).T
    else:
        data = rs.randint(120, 128, (1, 512, 5, 5)).astype(np.int8)
        weight = rs.randint(120, 128, (2, 512, 3, 3)).astype(np.int8)
        args = (data, weight, None, _r(-1.0), _r(1.0), _r(-1.0), _r(1.0))
        got, want = _both("quantized_conv", args,
                          {"kernel": (3, 3), "num_filter": 2,
                           "no_bias": True})
        exact = np.einsum("chw,ochw->o", data[0, :, :3, :3].astype(np.int64),
                          weight.astype(np.int64))
        got[0] = got[0][0, :, 0, 0]
        want[0] = want[0][0, :, 0, 0]
    assert np.abs(exact).max() > 2 ** 24
    np.testing.assert_array_equal(got[0], exact)
    _same(got, want)


def test_optimal_threshold_matches_jax():
    """The KL search (the port's own numpy copy) returns the JAX package's
    threshold on the same values: a Gaussian with far outliers, a uniform,
    a sparse ReLU-like and an all-zero input."""
    rs = np.random.RandomState(0)
    arrays = [np.concatenate([rs.normal(0, 1, 30_000), [50.0, -48.0]]),
              rs.uniform(-2, 2, 20_000),
              np.maximum(rs.normal(0, 1, 20_000), 0) ** 2,
              np.zeros(16)]
    for a in arrays:
        assert tqz._get_optimal_threshold(a) == \
            jqz._get_optimal_threshold(a)
    core = tqz._get_optimal_threshold(arrays[0])
    assert 3.0 < core < 25.0


# -- graphs and nets -----------------------------------------------------------

def _small_net(g, use_bias=True):
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(8, 3, padding=1, use_bias=use_bias),
            g.nn.Activation("relu"), g.nn.Flatten(),
            g.nn.Dense(6, use_bias=use_bias))
    return net


def _resnet18(g):
    return g.model_zoo.vision.resnet18_v1(classes=10)


def _gpt(g, **kw):
    return g.model_zoo.gpt.gpt_tiny(units=64, num_heads=4, **kw)


def _twins(make, x, seed, port_kw=None):
    """The port's net of ``make`` (Xavier from a seed, run once on
    ``x[:1]``), and the JAX net of the same make holding its values,
    parameter by parameter in order (its deferred shapes taken from them,
    so it skips the op-by-op first forward); both hybridized and run on
    ``x``."""
    with cpu():
        tnet = make(tgluon, **(port_kw or {}))
        tnet.initialize(init=tinit.Xavier(),
                        generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            tnet(tnd.array(x[:1]))
    jnet = make(jgluon)
    jnet.initialize()
    tp = list(tnet.collect_params().values())
    jp = list(jnet.collect_params().values())
    assert len(tp) == len(jp)
    rs = np.random.RandomState(seed)
    for t, j in zip(tp, jp):
        value = t.data().asnumpy()
        if t.name.endswith(("gamma", "running_var")):
            value = rs.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif t.name.endswith(("beta", "running_mean")):
            value = rs.uniform(-0.2, 0.2, value.shape).astype(np.float32)
        j._load_init(jnd.array(value))
        t.set_data(tnd.array(value, ctx=cpu()))
    jnet.hybridize()
    jnet(jnd.array(x))
    with cpu(), torch.no_grad():
        tnet.hybridize()
        tnet(tnd.array(x))
    return tnet, jnet


def _quant_nodes(sym, op):
    seen, out = set(), []
    for n in sym._topo():
        if n.op == op and n.name not in seen:
            seen.add(n.name)
            out.append(n)
    return out


def _ranges(sym, fed=None):
    """The calibrated ranges of the quantize_v2 nodes in graph order; with
    ``fed``, only those whose input is (``True``) or is not (``False``) a
    graph variable."""
    return [(n.attrs.get("min_calib_range"), n.attrs.get("max_calib_range"))
            for n in _quant_nodes(sym, "_contrib_quantize_v2")
            if fed is None or (n.inputs[0].op is None) == fed]


def _range_ulps(tsym, jsym):
    """At each point not fed by a graph input, the f32 ulps between the
    two packages' calibrated ranges (the larger of min's and max's)."""
    t, j = (np.array(_ranges(s, fed=False), np.float32).view(np.int32)
            .astype(np.int64) for s in (tsym, jsym))
    return np.abs(t - j).max(axis=1).tolist()


def _int8_params(block):
    return [p.data().asnumpy() for p in block.collect_params().values()
            if np.dtype(p.data().dtype) == np.int8]


def _hold(tq_net, jq_net, x, jax_forward=None, float_bitwise=True):
    """int8 codes bitwise, outputs within ``QNET_TOL`` of the JAX
    package's, and the calibration ranges: bitwise where the float ops
    before every insertion point agree bitwise across the packages
    (``float_bitwise``); else bitwise at the points fed by a graph input
    and within ``RANGE_RTOL`` at the others, whose inputs the two
    packages' float convolutions or attention sum in other orders."""
    tsym, jsym = tq_net._outputs_sym, jq_net._outputs_sym
    assert len(_ranges(tsym)) == len(_ranges(jsym))
    assert _ranges(tsym, fed=True) == _ranges(jsym, fed=True)
    if float_bitwise:
        assert _ranges(tsym) == _ranges(jsym)
    else:
        np.testing.assert_allclose(
            np.array(_ranges(tsym, fed=False), np.float64),
            np.array(_ranges(jsym, fed=False), np.float64),
            rtol=RANGE_RTOL, atol=0)
    got, want = _int8_params(tq_net), _int8_params(jq_net)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with cpu(), torch.no_grad():
        out = tq_net(tnd.array(x)).asnumpy()
    ref = np.asarray(jax_forward(x) if jax_forward else
                     jq_net(jnd.array(x)).asnumpy())
    assert np.abs(out - ref).max() <= QNET_TOL * np.abs(ref).max()
    return out, ref


def _jit_forward(qnet):
    """The JAX package's quantized SymbolBlock as one jitted program."""
    params = {n: p.data()._data for n, p in qnet.collect_params().items()}
    fn = jax.jit(lambda p, d: qnet._outputs_sym.eval_raw(data=d, **p))
    return lambda x: fn(params, jnp.asarray(x))


@pytest.fixture(scope="module")
def conv_nets():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3, 8, 8).astype(np.float32)
    calib = [rs.randn(4, 3, 8, 8).astype(np.float32) for _ in range(3)]
    return _twins(_small_net, x, 3) + (x, calib)


def _resnet18_case():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 32, 32).astype(np.float32)
    calib = [rs.randn(2, 3, 32, 32).astype(np.float32) for _ in range(2)]
    return _twins(_resnet18, x, 4) + (x, calib)


@pytest.fixture(scope="module")
def resnet18_nets():
    return _resnet18_case()


def _quantize_both(tnet, jnet, calib, mode):
    jqn = jqz.quantize_net(jnet, calib_data=[jnd.array(c) for c in calib],
                           calib_mode=mode)
    with cpu():
        tqn = tqz.quantize_net(tnet, calib_data=[tnd.array(c)
                                                 for c in calib],
                               calib_mode=mode)
    return tqn, jqn


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_conv_net(conv_nets, mode):
    """The JAX tests' conv net: its float ops agree bitwise across the
    packages, so the ranges do too; the weights are int8 on the host."""
    tnet, jnet, x, calib = conv_nets
    tqn, jqn = _quantize_both(tnet, jnet, calib, mode)
    _hold(tqn, jqn, x)
    for p in tqn.collect_params().values():
        if p.name.endswith("weight"):
            assert p.data()._data.dtype == torch.int8
            assert p.data()._data.device.type == "cpu"


def test_quantize_net_resnet18(resnet18_nets):
    """resnet18_v1 at 32x32, naive (the entropy search, ~0.2 s a point in
    each package, runs on the conv net and gpt_tiny)."""
    tnet, jnet, x, calib = resnet18_nets
    tqn, jqn = _quantize_both(tnet, jnet, calib, "naive")
    assert len(_quant_nodes(tqn._outputs_sym,
                            "_contrib_quantized_conv")) == 20
    _hold(tqn, jqn, x, _jit_forward(jqn), float_bitwise=False)


def _gpt_case():
    ids = np.random.RandomState(0).randint(0, 128, (4, 16)) \
        .astype(np.float32)
    return _twins(_gpt, ids, 5, port_kw={"attention_impl": "flash",
                                         "device": cpu()}) + (ids,)


@pytest.fixture(scope="module")
def gpt_nets():
    return _gpt_case()


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_gpt_tiny_flash_against_dense(gpt_nets, mode):
    """gpt_tiny: dense attention in the JAX package, the flash op (its
    plain version on the host) in the port; the FFN goes int8 in both."""
    tnet, jnet, ids = gpt_nets
    tqn, jqn = _quantize_both(tnet, jnet, [ids], mode)
    assert len(_quant_nodes(tqn._outputs_sym,
                            "_contrib_quantized_fully_connected")) == 4
    out, ref = _hold(tqn, jqn, ids, _jit_forward(jqn), float_bitwise=False)
    assert (out[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).all()


def test_quantize_model_excluded_and_no_bias():
    """One graph for both packages (built in the JAX package, read by the
    port from its JSON): the excluded convolution stays float with a float
    weight, the no-bias convolution and the FC go int8; the rewritten
    graphs hold the same ops, the codes are bitwise and the outputs
    agree."""
    rs = np.random.RandomState(2)
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Conv2D(4, 3, padding=1), jgluon.nn.Activation("relu"),
            jgluon.nn.Conv2D(6, 3, padding=1, use_bias=False),
            jgluon.nn.Flatten(), jgluon.nn.Dense(5))
    net.initialize(init=mx.init.Xavier())
    net.hybridize()
    x = rs.randn(2, 3, 6, 6).astype(np.float32)
    net(jnd.array(x))
    jsym = mx.sym.trace_block(net)
    tsym = tmx.sym.fromjson(jsym.tojson())
    args = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    first = [n.name for n in jsym._topo() if n.op == "Convolution"][0]
    jout = jqz.quantize_model(jsym, {k: jnd.array(v) for k, v in
                                     args.items()}, {}, calib_mode="naive",
                              calib_data=[jnd.array(x)],
                              excluded_sym_names=[first])
    with cpu():
        tout = tqz.quantize_model(tsym, {k: tnd.array(v) for k, v in
                                         args.items()}, {},
                                  calib_mode="naive",
                                  calib_data=[tnd.array(x)],
                                  excluded_sym_names=[first])
    (jq_sym, jq_arg, _), (tq_sym, tq_arg, _) = jout, tout
    assert [n.op for n in tq_sym._topo()] == [n.op for n in jq_sym._topo()]
    assert sorted(tq_arg) == sorted(jq_arg)
    for k in jq_arg:
        np.testing.assert_array_equal(tq_arg[k].asnumpy(),
                                      np.asarray(jq_arg[k].asnumpy()))
    wname = [k for k in args if k.endswith("weight")]
    assert tq_arg[wname[0]].dtype == np.float32
    assert all(tq_arg[k].dtype == np.int8 for k in wname[1:])
    assert _ranges(tq_sym) == _ranges(jq_sym)
    feed = {k: v.asnumpy() for k, v in tq_arg.items()}
    with cpu(), torch.no_grad():
        got = tq_sym.eval(data=tnd.array(x), **{
            k: tnd.array(v, dtype=v.dtype) for k, v in feed.items()})
    want = jq_sym.eval(data=jnd.array(x), **jq_arg)
    np.testing.assert_allclose(got.asnumpy(), np.asarray(want.asnumpy()),
                               rtol=0, atol=QNET_TOL * float(
                                   np.abs(np.asarray(want.asnumpy())).max()))


def test_quantize_block_and_collector():
    """quantize_block's ranges and the percentile collector against the
    JAX package's."""
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3, 8, 8).astype(np.float32)
    tnet, jnet = _twins(_small_net, x, 6)
    _, jr = jqz.quantize_block(jnet, calib_data=[jnd.array(x)])
    with cpu():
        _, tr = tqz.quantize_block(tnet, calib_data=[tnd.array(x)])
    # names carry each package's layer counters: compare in insertion order
    assert [k.split("_")[-1] for k in jr] == [k.split("_")[-1] for k in tr]
    np.testing.assert_allclose(np.array(list(tr.values())),
                               np.array(list(jr.values())), rtol=1e-6)
    a = rs.randn(1000).astype(np.float32)
    jc = jqz.CalibrationCollector("percentile")
    tc = tqz.CalibrationCollector("percentile")
    assert tc.collect("x", torch.from_numpy(a)) == jc.collect("x", a)


if __name__ == "__main__":
    # the f32 ulps between the packages' ranges at the points RANGE_RTOL
    # holds, the cases of the two tests above that hold them so; run with
    # JAX_PLATFORMS=cpu and the repository root on PYTHONPATH
    tnet, jnet, x, calib = _resnet18_case()
    tqn, jqn = _quantize_both(tnet, jnet, calib, "naive")
    print("resnet18_v1 32x32 naive",
          _range_ulps(tqn._outputs_sym, jqn._outputs_sym))
    tnet, jnet, ids = _gpt_case()
    for mode in ("naive", "entropy"):
        tqn, jqn = _quantize_both(tnet, jnet, [ids], mode)
        print("gpt_tiny", mode, _range_ulps(tqn._outputs_sym,
                                            jqn._outputs_sym))
