"""NDArray parity: ``mxnet_tpu_torch.nd`` against ``mxnet_tpu.nd``.

Each case of ``tests/test_ndarray.py`` that falls in the ported modules
runs the same numpy inputs through both packages (the port under ``with
mx.cpu():``) and compares every result: values within rtol 1e-4 /
atol 1e-5 (``test_operator.py``'s forward tolerance; most are exact),
equal shapes and dtypes.  The JAX NDArray has value semantics; the
aliasing case writes through every mutation route and reads every alias
in both packages.  The ``.params`` format is held across packages in
both directions, bfloat16 and int64 included.  Random draws differ by
construction (threefry against Philox): the port is held to its own seed
determinism, shapes and dtypes, and moments within 5 sigma of the
distribution.  Left out: ``foreach`` and ``linalg`` (their
sub-namespaces are not ported) and the nightly large-array case.
"""

import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

TOL = dict(rtol=1e-4, atol=1e-5)
JAX = (jmx, jnd, jag)
PORT = (tmx, tnd, tag)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return np.asarray(x.asnumpy())
    return np.asarray(x)


def _same(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               err_msg=what, **TOL)


def both(case):
    """Run ``case(mx, nd, autograd)`` in both packages; compare."""
    want = case(*JAX)
    with tmx.cpu():
        got = case(*PORT)
    _same(got, want, case.__name__)
    return got


def test_creation():
    def case(mx, nd, ag):
        return {"z": nd.zeros((2, 3)), "o": nd.ones((4,), dtype="int32"),
                "f": nd.full((2, 2), 7.5), "a": nd.array([[1, 2], [3, 4]]),
                "r": nd.arange(0, 10, 2), "l": nd.linspace(0, 1, 5),
                "l2": nd.linspace(0, 1, 4, endpoint=False),
                "e": nd.eye(3, 4, 1), "b": nd.array(np.array([True, False])),
                "r2": nd.arange(3, repeat=2), "emp": nd.empty((2,))}
    got = both(case)
    assert got["z"].dtype == np.float32 and got["a"].dtype == np.float32


def test_arithmetic_and_comparison():
    a0 = np.array([1.0, 2.0, 3.0], np.float32)
    b0 = np.array([4.0, 5.0, 6.0], np.float32)

    def case(mx, nd, ag):
        a, b = nd.array(a0), nd.array(b0)
        return [a + b, a - b, a * b, b / a, a ** 2, 2 + a, 1 - a, -a,
                2 ** a, a % 2, 3 / a, abs(-a), a @ b, a == b, a != b,
                a < b, a >= b, a > 2, a <= 2, a + b0, b0 - a]

    both(case)


def test_inplace_version_bump():
    def case(mx, nd, ag):
        a = nd.zeros((3,))
        v0 = a.version
        a += 1
        assert a.version > v0
        a *= 3
        b = a.copy()
        b -= 1
        b /= 4
        return [a, b]

    both(case)


def test_setitem_getitem():
    def case(mx, nd, ag):
        a = nd.zeros((3, 4))
        a[1] = 5.0
        a[0, 2] = 1.0
        a[2, 1:3] = nd.array([7.0, 8.0])
        idx = nd.array([0, 2], dtype="int32")
        return [a, a[1], a[0:2, 1:3], a[idx], a[nd.array([2.0, 1.0])],
                a[:, 1], a[-1]]

    both(case)


def test_reshape_special_codes():
    def case(mx, nd, ag):
        a = nd.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        return [a.reshape((-1,)), a.reshape((0, -1)), a.reshape((-2,)),
                a.reshape((-3, 0)), a.reshape(6, 4),
                a.reshape((-4, 1, 2, 0, 0)),
                nd.reshape(a, shape=(0, -1), reverse=True),
                a.reshape(shape=(4, 6)), a.T, a.reshape_like(nd.zeros((6, 4)))]

    both(case)


def test_dot_reduce_broadcast():
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 4)).astype(np.float32)
    m1, m2 = rng.random((3, 4)), rng.random((4, 5))

    def case(mx, nd, ag):
        a = nd.array(x)
        return [nd.dot(nd.array(m1), nd.array(m2)),
                nd.dot(nd.array(m1), nd.array(m1), transpose_b=True),
                nd.sum(a), nd.sum(a, axis=1), nd.mean(a, axis=(0, 2)),
                nd.max(a, axis=1, keepdims=True),
                nd.sum(a, axis=1, exclude=True), a.sum(), a.mean(axis=2),
                nd.broadcast_add(nd.array(x[:, :1]), nd.array(x[:1])),
                nd.broadcast_to(nd.ones((1, 3)), shape=(4, 3)),
                nd.sum(nd.array([1, 2], dtype="int32")),
                a.argmax(axis=2), a.norm(), a.prod(axis=0)]

    both(case)


def test_concat_split_stack():
    def case(mx, nd, ag):
        a, b = nd.ones((2, 3)), nd.zeros((2, 3))
        c = nd.concat(a, b, dim=0)
        parts = nd.split(c, num_outputs=2, axis=0)
        return [c, list(parts), nd.stack(a, b, axis=0),
                nd.concatenate([a, b], axis=1), nd.moveaxis(c, 0, 1)]

    both(case)


def test_unary_math():
    x = np.random.default_rng(1).random(5).astype(np.float32) + 0.5

    def case(mx, nd, ag):
        a = nd.array(x)
        return [nd.exp(a), nd.log(a), nd.sqrt(a), nd.rsqrt(a),
                nd.sigmoid(a), nd.relu(nd.array([-1.0, 1.0])), a.exp(),
                a.square(), a.clip(0.6, 1.0)]

    both(case)


def test_indexing_ops():
    def case(mx, nd, ag):
        w = nd.array(np.arange(12).reshape(4, 3).astype(np.float32))
        idx = nd.array([0, 2], dtype="int32")
        return [nd.take(w, idx), nd.one_hot(idx, depth=4),
                nd.pick(w, nd.array([1, 0, 2, 1]), axis=1), w.take(idx)]

    both(case)


def test_topk_sort():
    def case(mx, nd, ag):
        a = nd.array([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]])
        return [nd.topk(a, k=2), list(nd.topk(a, k=1, ret_typ="both")),
                nd.sort(a, is_ascend=False), a.argsort(),
                nd.topk(a, k=2, ret_typ="mask")]

    both(case)


def test_astype_cast():
    def case(mx, nd, ag):
        a = nd.array([1.5, 2.5])
        return [a.astype("int32"), nd.cast(a, dtype="float16"),
                a.astype(np.float64)]

    got = both(case)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float16


def test_context_roundtrip():
    a = tnd.ones((2, 2), ctx=tmx.cpu(0))
    assert a.context.device_type == "cpu"
    assert a.as_in_context(tmx.cpu(0)) is a
    assert a.context == torch.device("cpu")
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tnd.zeros((1,)).context == tmx.cpu()


def test_copyto():
    def case(mx, nd, ag):
        a, b = nd.ones((2, 2)), nd.zeros((2, 2), dtype="int32")
        a.copyto(b)
        c = a.copyto(mx.cpu())
        return [b, c]

    both(case)


def test_save_load(tmp_path):
    def case(mx, nd, ag):
        f = str(tmp_path / f"{mx.__name__}.params")
        nd.save(f, {"a": nd.array([1.0, 2.0]),
                    "b": nd.ones((2, 3), dtype="int32")})
        back = nd.load(f)
        nd.save(f, [nd.zeros((2,)), nd.ones((3,))])
        lst = nd.load(f)
        assert isinstance(lst, list)
        return [back["a"], back["b"], lst]

    both(case)


def test_wait_and_waitall():
    with tmx.cpu():
        a = tnd.ones((100, 100))
        b = tnd.dot(a, a)
        assert b.wait_to_read() is b
        tnd.waitall()
        assert float(b[0, 0]) == 100.0


def test_scalar_conversions():
    def case(mx, nd, ag):
        a = nd.array([3.5])
        assert float(a) == 3.5 and a.asscalar() == pytest.approx(3.5)
        assert int(nd.array([7], dtype="int32")) == 7
        with pytest.raises(mx.MXNetError):
            nd.zeros((2, 2)).asscalar()
        return [a.item(), a.tolist(), len(nd.zeros((4, 1))),
                [x for x in nd.array([1.0, 2.0])]]

    both(case)


def test_where_clip():
    def case(mx, nd, ag):
        cond = nd.array([1.0, 0.0, 1.0])
        return [nd.where(cond, nd.ones((3,)), nd.zeros((3,))),
                nd.clip(nd.array([-2.0, 0.5, 9.0]), 0.0, 1.0)]

    both(case)


def test_explicit_64bit_dtypes_roundtrip(tmp_path):
    def case(mx, nd, ag):
        i64 = nd.array(np.array([5, 2_199_999_999], np.int64),
                       dtype="int64")
        f64 = nd.array(np.array([1.5, 1e300]), dtype="float64")
        f = str(tmp_path / f"{mx.__name__}-big.params")
        nd.save(f, {"i": i64, "f": f64})
        back = nd.load(f)
        return [i64, f64, back["i"], back["f"]]

    got = both(case)
    assert got[0].dtype == np.int64 and int(got[2].asnumpy()[1]) \
        == 2_199_999_999


def test_64bit_creators_and_casts():
    def case(mx, nd, ag):
        a = nd.array(np.array([2.2e9]), dtype="float64")
        return [nd.zeros((3,), dtype="int64"), nd.ones((2,), dtype="float64"),
                nd.full((2,), 2_199_999_999, dtype="int64"),
                nd.arange(2_199_999_998, 2_200_000_001, 1, dtype="int64"),
                a.astype("int64"), nd.cast(a, dtype="int64"),
                nd.linspace(0, 1e300, 3, dtype="float64"),
                nd.eye(3, dtype="int64")]

    both(case)


def test_64bit_pickle_setitem_and_tape_getitem():
    def case(mx, nd, ag):
        a = nd.array(np.array([2_199_999_999], np.int64), dtype="int64")
        b = pickle.loads(pickle.dumps(a))
        c = nd.zeros((4,), dtype="int64")
        c[0] = 2_200_000_000
        x = nd.array(np.arange(6, dtype=np.float32))
        x.attach_grad()
        with ag.record():
            y = (x[1:4] * 2).sum()
        y.backward()
        return [b, c, x.grad]

    both(case)


def test_bf16_arrays_and_pickle():
    x = np.array([1.5, -2.25, 3.0], np.float32)

    def case(mx, nd, ag):
        a = nd.array(x, dtype="bfloat16")
        b = pickle.loads(pickle.dumps(a))
        return [a.astype("float32"), b.astype("float32"),
                (a * 2).astype("float32")]

    both(case)
    with tmx.cpu():
        assert tnd.array(x, dtype="bfloat16").dtype == torch.bfloat16


# -- aliasing: value semantics across every mutation route -------------------

def test_aliasing_value_semantics():
    base = np.arange(12, dtype=np.float32).reshape(3, 4)

    def case(mx, nd, ag):
        x = nd.array(base)
        aliases = {"slice": x[1:3], "row": x[0], "detach": x.detach(),
                   "reshape": x.reshape((4, 3)), "T": x.T,
                   "same_ctx": x.as_in_context(x.context),
                   "copy": x.copy(), "astype": x.astype("float32"),
                   "expand": x.expand_dims(0), "flat": x.flatten()}
        x[:] = 100.0
        x[1:3] = nd.ones((2, 4)) * 7
        x += 1
        nd.elemwise_add(x, x, out=x)
        out = {k: v for k, v in aliases.items() if k != "same_ctx"}
        out["x"] = x
        out["same_ctx_is_x"] = np.array(aliases["same_ctx"] is x)
        return out

    got = both(case)
    np.testing.assert_array_equal(got["slice"].asnumpy(), base[1:3])
    np.testing.assert_array_equal(got["detach"].asnumpy(), base)


def test_views_never_share_storage():
    """The port's rule behind value semantics: no two NDArrays share a
    buffer, so a write in place through one (a runtime kernel's
    non-const pointer) reaches no other."""
    with tmx.cpu():
        x = tnd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        views = [x[1:3], x[0], x.detach(), x.reshape((4, 3)), x.T,
                 x.copy(), x.astype("float32"), tnd.identity(x),
                 tnd.stop_gradient(x), x.flatten(), x.expand_dims(0),
                 tnd.broadcast_to(x[0:1], shape=(2, 4))]
        ptr = x._data.untyped_storage().data_ptr()
        for v in views:
            assert v._data.untyped_storage().data_ptr() != ptr
        x._data.fill_(-1.0)          # an in-place write, as a kernel's
        assert float(views[0][0, 0]) == 4.0
        assert float(views[2][0, 0]) == 0.0


def test_nd_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tnd.array([1.0])._data.device.type == "cuda"
    else:
        with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
            tnd.array([1.0])
        with pytest.raises(tmx.MXNetError):
            tnd.zeros((2,))


# -- the .params format across packages --------------------------------------

ARRAYS = {
    "f32": (np.arange(6, dtype=np.float32).reshape(2, 3) / 7, None),
    "f64": (np.array([1e300, -2.5]), "float64"),
    "i64": (np.array([5, 2_199_999_999, -3], np.int64), "int64"),
    "i32": (np.array([[1, -2]], np.int32), "int32"),
    "f16": (np.array([0.5, 1.25, -3.0], np.float16), "float16"),
    "u8": (np.array([0, 255, 7], np.uint8), "uint8"),
    "i8": (np.array([-128, 5], np.int8), "int8"),
    "bf16": (np.array([1.5, -2.25, 3.0e3, 1e-3], np.float32), "bfloat16"),
    "scalar": (np.array(2.5, np.float32), None),
}


def _make(nd):
    return {k: nd.array(v, dtype=d) for k, (v, d) in ARRAYS.items()}


def _host(a):
    if str(a.dtype) in ("bfloat16", "torch.bfloat16"):
        return np.asarray(a.astype("float32").asnumpy()), "bfloat16"
    return np.asarray(a.asnumpy()), np.dtype(a.dtype).name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_params_file_across_packages(tmp_path, direction):
    f = str(tmp_path / "x.params")
    with tmx.cpu():
        src_nd, dst_nd = (jnd, tnd) if direction == "jax_to_port" \
            else (tnd, jnd)
        src = _make(src_nd)
        src_nd.save(f, src)
        back = dst_nd.load(f)
    assert set(back) == set(src)
    for k in src:
        (a, ta), (b, tb) = _host(src[k]), _host(back[k])
        assert ta == tb, (k, ta, tb)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_params_bytes_identical(tmp_path):
    fj, ft = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnd.save(fj, _make(jnd))
    with tmx.cpu():
        tnd.save(ft, _make(tnd))
    assert open(fj, "rb").read() == open(ft, "rb").read()


def test_sparse_record_raises(tmp_path):
    """The JAX package's compact sparse record loads as a compact array;
    a sparse storage type under the upstream v2 magic, whose layout
    neither package reads, still raises."""
    import struct

    f = str(tmp_path / "s.params")
    rsp = jnd.sparse.row_sparse_array(jnd.array(np.eye(3, dtype=np.float32)))
    jnd.save(f, [rsp])
    with tmx.cpu():
        (got,) = tnd.load(f)
    assert got.stype == "row_sparse" and got.num_stored_rows == 3
    np.testing.assert_array_equal(got.asnumpy(), np.eye(3))
    v2 = str(tmp_path / "v2.params")
    with open(v2, "wb") as out:
        out.write(struct.pack("<QQQ", 0x112, 0, 1))
        out.write(struct.pack("<Iii", 0xF993FAC9, 1, 1))
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="sparse"):
        tnd.load(v2)


# -- random: determinism, shapes, dtypes, moments ----------------------------

def test_random_seed_determinism_and_types():
    with tmx.cpu():
        a = tnd.random.uniform(0, 1, shape=(100,))
        assert a.shape == (100,) and a.dtype == np.float32
        assert 0 <= float(tnd.min(a)) and float(tnd.max(a)) <= 1
        c = tnd.random.randint(0, 10, shape=(50,))
        assert c.dtype == np.int32
        draws = []
        for _ in range(2):
            tmx.random.seed(42)
            draws.append([tnd.random.uniform(shape=(5,)).asnumpy(),
                          tnd.random.normal(shape=(3,)).asnumpy(),
                          tmx.random.poisson(lam=2.0, shape=(4,)).asnumpy()])
        for x1, x2 in zip(*draws):
            np.testing.assert_array_equal(x1, x2)
        tmx.random.seed(43)
        assert not np.array_equal(tnd.random.uniform(shape=(5,)).asnumpy(),
                                  draws[0][0])
        m = tnd.random.multinomial(tnd.array([[0.2, 0.3, 0.5]]), shape=(4,),
                                   get_prob=True)
        assert m[0].shape == (1, 4) and m[1].shape == (1, 4)
        s = tnd.random.shuffle(tnd.arange(6))
        assert sorted(s.asnumpy().tolist()) == list(range(6))


N = 20000
# (op, kwargs, mean, variance) of each distribution
MOMENTS = [
    ("uniform", {"low": -1.0, "high": 3.0}, 1.0, 16 / 12),
    ("normal", {"loc": 2.0, "scale": 0.5}, 2.0, 0.25),
    ("gamma", {"alpha": 2.5, "beta": 2.0}, 5.0, 10.0),
    ("gamma", {"alpha": 0.5, "beta": 1.0}, 0.5, 0.5),
    ("exponential", {"lam": 4.0}, 0.25, 1 / 16),
    ("poisson", {"lam": 3.0}, 3.0, 3.0),
    ("negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25),
    ("generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5}, 2.0, 4.0),
    ("randint", {"low": 0, "high": 10}, 4.5, 99 / 12),
    ("bernoulli", {"p": 0.3}, 0.3, 0.21),
]


@pytest.mark.parametrize("op,kw,mean,var", MOMENTS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MOMENTS)])
def test_random_moments_within_5_sigma(op, kw, mean, var):
    """The port's sample mean against the distribution's (which the JAX
    package's sampler also has: its sample is checked the same way),
    within 5 standard errors."""
    for nd, ctx in ((jnd, None), (tnd, tmx.cpu())):
        if ctx is None:
            jmx.random.seed(7)
            x = getattr(nd.random, op)(shape=(N,), **kw).asnumpy()
        else:
            with ctx:
                tmx.random.seed(7)
                x = getattr(nd.random, op)(shape=(N,), **kw).asnumpy()
        x = x.astype(np.float64)
        assert abs(x.mean() - mean) <= 5 * np.sqrt(var / N), (nd, x.mean())
        assert abs(x.var() - var) <= 0.1 * var + 5 * np.sqrt(var / N), (
            nd, x.var())


def test_sample_ops_with_array_params():
    with tmx.cpu():
        lo, hi = tnd.array([0.0, 10.0]), tnd.array([1.0, 20.0])
        u = tnd.sample_uniform(lo, hi, shape=(N // 10,))
        assert u.shape == (2, N // 10)
        mu, sig = tnd.array([0.0, 5.0]), tnd.array([1.0, 0.1])
        z = tnd.sample_normal(mu, sig, shape=(N // 10,)).asnumpy()
    un = u.asnumpy()
    assert (un[0] >= 0).all() and (un[0] < 1).all() and (un[1] >= 10).all()
    assert abs(z[1].mean() - 5.0) < 5 * 0.1 / np.sqrt(N // 10)


@pytest.mark.parametrize("sync", [False, True])
def test_profiler_records_operator_spans(sync):
    """While ``mx.profiler`` runs, each imperative op is an ``operator``
    span in the Chrome trace (the JAX package's dispatch does the same);
    the sync mode waits for the result inside the span."""
    import json

    from mxnet_tpu_torch import profiler

    with tmx.cpu():
        a = tnd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        profiler.dumps(reset=True)
        profiler.set_config(profile_sync=sync)
        profiler.set_state("run")
        try:
            b = tnd.relu(a * 2 - 3)
            tnd.sum(b).asnumpy()
        finally:
            profiler.set_state("stop")
            profiler.set_config(profile_sync=False)
        trace = json.loads(profiler.dumps(reset=True))
    ops = [e["name"] for e in trace["traceEvents"]
           if e.get("cat") == "operator"]
    assert "relu" in ops and "sum" in ops, ops
    # stopped: no more spans
    with tmx.cpu():
        tnd.relu(a)
    assert not [e for e in json.loads(profiler.dumps())["traceEvents"]
                if e.get("cat") == "operator"]
