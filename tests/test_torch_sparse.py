"""The port's sparse storage against the JAX package's, on the CPU, case by
case after ``tests/test_sparse.py``: the same numpy inputs go through
both packages and the results are compared.

- compact storage (row-sparse and CSR), the dense ops over it, zeros;
- ``sparse_embedding``'s compact gradient, the clip of out-of-range ids,
  ``grad_req="add"``;
- the lazy SGD and Adam updates on touched rows only, and
  ``lazy_update=False``; ``gluon.Trainer.step`` through the grouped
  row-sparse rule without ever reading a dense view;
- ``row_sparse_pull``, duplicate ids included;
- CSR ``dot`` in every transpose and ``out=`` form, and its gradient;
- ``cast_storage``, dtype kept; ``LibSVMIter``'s CSR batches;
- the compact elementwise ops and the ``.params`` round trip, across the
  two packages.

Tolerances: outputs rtol 1e-4 / atol 1e-5, gradients rtol 2e-3 / atol
2e-4, weights after steps rtol 2e-4 / atol 2e-5, except the row-sparse
gradient compression through the one-worker store, held bitwise to the
reference test's numpy oracle in both packages.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ndarray import sparse as tsp
from torch_one_thread import one_torch_thread  # noqa: F401

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
WEIGHT_TOL = dict(rtol=2e-4, atol=2e-5)

JAX = SimpleNamespace(mx=jmx, nd=jnd, ag=jag, nn=jnn, sp=jsp,
                      scope=nullcontext)
PORT = SimpleNamespace(mx=tmx, nd=tnd, ag=tag, nn=tnn, sp=tsp,
                       scope=tmx.cpu)


def _both(fn):
    """``fn(P)`` for the port and for the JAX package; (port, jax)."""
    out = []
    for P in (PORT, JAX):
        with P.scope():
            out.append(fn(P))
    return out


def _close(got, want, tol):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


# -- storage -------------------------------------------------------------------

def test_row_sparse_compact_storage():
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([1, 5, 98])

    def case(P):
        a = P.sp.row_sparse_array((vals, idx), shape=(100, 4))
        assert a.num_stored_rows == 3 and a.shape == (100, 4)
        assert a.stype == "row_sparse"
        dense = a.tostype("default")
        back = dense.tostype("row_sparse")
        assert isinstance(back, P.sp.RowSparseNDArray)
        assert back.num_stored_rows == 3
        return [a.indices.asnumpy(), a.data.asnumpy(), dense.asnumpy(),
                back.asnumpy()]

    got, want = _both(case)
    assert tuple(got[1].shape) == (3, 4)      # the compact values
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_row_sparse_dense_ops_work():
    def case(P):
        a = P.sp.row_sparse_array((np.ones((2, 3), np.float32), [0, 4]),
                                  shape=(6, 3))
        return [(a * 2).asnumpy(), (a + P.nd.ones((6, 3))).asnumpy()]

    got, want = _both(case)
    _close(got, want, OUT_TOL)
    assert got[0].sum() == 12.0


def test_csr_compact_storage():
    data = np.array([1.0, 2.0, 3.0], np.float32)
    indices = np.array([0, 2, 1])
    indptr = np.array([0, 2, 2, 3])

    def case(P):
        a = P.sp.csr_matrix((data, indices, indptr), shape=(3, 4))
        assert isinstance(a, P.sp.CSRNDArray) and a.stype == "csr"
        b = a.tostype("default").tostype("csr")
        return [a.asnumpy(), a.indptr.asnumpy(), a.data.asnumpy(),
                b.data.asnumpy(), b.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sparse_zeros():
    def case(P):
        z = P.sp.zeros("row_sparse", (50, 8))
        c = P.sp.zeros("csr", (4, 6))
        assert z.num_stored_rows == 0 and z.shape == (50, 8)
        return [z.asnumpy(), c.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the compact gradient --------------------------------------------------------

def _embedding(P, vocab, dim, table, sparse_grad=True):
    emb = P.nn.Embedding(vocab, dim, sparse_grad=sparse_grad)
    emb.initialize()
    emb.weight.set_data(P.nd.array(table))
    return emb


def test_embedding_sparse_grad_is_compact():
    """A 10k-row table touched by 4 distinct ids has a gradient of 4 rows,
    equal to the JAX package's and to the dense path's."""
    vocab, dim = 10000, 8
    table = np.random.RandomState(0).randn(vocab, dim).astype(np.float32)
    ids = np.array([[3, 77, 3], [500, 9999, 77]], np.float32)

    def case(P):
        out = []
        for sparse in (True, False):
            emb = _embedding(P, vocab, dim, table, sparse)
            with P.ag.record():
                y = emb(P.nd.array(ids))
                loss = (y * y).sum()
            loss.backward()
            g = emb.weight.grad()
            if sparse:
                assert isinstance(g, P.sp.RowSparseNDArray)
                assert g.num_stored_rows == 4
                out += [g.indices.asnumpy(), g.data.asnumpy()]
            out.append(g.asnumpy())
        return out

    got, want = _both(case)
    np.testing.assert_array_equal(got[0], [3, 77, 500, 9999])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == (4, dim)          # O(touched), not O(vocab)
    _close(got[1:], want[1:], GRAD_TOL)
    _close(got[2], got[3], GRAD_TOL)         # sparse == dense path


def test_sparse_embedding_clips_out_of_range_ids():
    """The backward scatters at the clipped ids the forward read: -1 is
    row 0, an id >= vocab the last row."""
    table = np.random.RandomState(1).randn(10, 4).astype(np.float32)

    def case(P):
        emb = _embedding(P, 10, 4, table)
        with P.ag.record():
            loss = emb(P.nd.array(np.array([[-1.0, 12.0]], np.float32))).sum()
        loss.backward()
        g = emb.weight.grad()
        assert isinstance(g, P.sp.RowSparseNDArray)
        return [np.sort(g.indices.asnumpy()), g.asnumpy()]

    got, want = _both(case)
    np.testing.assert_array_equal(got[0], [0, 9])
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1], want[1], GRAD_TOL)
    np.testing.assert_allclose(got[1][0], np.ones(4))
    np.testing.assert_allclose(got[1][9], np.ones(4))


def test_grad_req_add_accumulates_sparse():
    table = np.random.RandomState(2).randn(100, 4).astype(np.float32)

    def case(P):
        emb = _embedding(P, 100, 4, table)
        emb.weight.grad_req = "add"
        for ids in ([[1, 2]], [[2, 3]]):
            with P.ag.record():
                loss = emb(P.nd.array(np.array(ids, np.float32))).sum()
            loss.backward()
        g = emb.weight.grad()
        assert isinstance(g, P.sp.RowSparseNDArray)
        assert g.num_stored_rows == 3
        return [g.indices.asnumpy(), g.asnumpy()]

    got, want = _both(case)
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1], want[1], GRAD_TOL)
    np.testing.assert_allclose(got[1][2], 2 * np.ones(4))


def test_attach_grad_row_sparse_on_nd():
    """``attach_grad(stype='row_sparse')`` on a plain array: a compact
    buffer that backward fills, as the JAX package's does."""
    w = np.random.RandomState(3).randn(20, 3).astype(np.float32)

    def case(P):
        x = P.nd.array(w)
        x.attach_grad(stype="row_sparse")
        assert x.grad.stype == "row_sparse" and x.grad.num_stored_rows == 0
        with P.ag.record():
            loss = (P.nd.Embedding(P.nd.array([4.0, 7.0, 4.0]), x,
                                   input_dim=20, output_dim=3) ** 2).sum()
        loss.backward()
        return x.grad.asnumpy()

    got, want = _both(case)
    _close(got, want, GRAD_TOL)


# -- the lazy updates ----------------------------------------------------------

def test_sparse_sgd_lazy_update_touches_only_rows():
    rng = np.random.RandomState(0)
    vocab, dim = 200, 4
    w0 = rng.randn(vocab, dim).astype(np.float32)
    idx = np.array([7, 42])
    gvals = rng.randn(2, dim).astype(np.float32)

    def case(P):
        weight = P.nd.array(w0)
        grad = P.sp.row_sparse_array((gvals, idx), shape=(vocab, dim))
        opt = P.mx.optimizer.SGD(learning_rate=0.5, momentum=0.9, wd=0.0)
        state = opt.create_state(0, weight)
        opt.update(0, weight, grad, state)
        return [weight.asnumpy(), state.asnumpy()]

    got, want = _both(case)
    _close(got, want, WEIGHT_TOL)
    untouched = np.setdiff1d(np.arange(vocab), idx)
    np.testing.assert_array_equal(got[0][untouched], w0[untouched])
    assert np.all(got[1][untouched] == 0) and np.any(got[1][idx] != 0)


def test_sparse_adam_matches_dense_on_touched_rows():
    rng = np.random.RandomState(1)
    vocab, dim = 50, 3
    w0 = rng.randn(vocab, dim).astype(np.float32)
    idx = np.array([2, 30])
    gvals = rng.randn(2, dim).astype(np.float32)
    gd = np.zeros((vocab, dim), np.float32)
    gd[idx] = gvals

    def case(P):
        out = []
        for g in (P.sp.row_sparse_array((gvals, idx), shape=(vocab, dim)),
                  P.nd.array(gd)):
            w = P.nd.array(w0)
            opt = P.mx.optimizer.Adam(learning_rate=0.01)
            opt.update(0, w, g, opt.create_state(0, w))
            out.append(w.asnumpy())
        return out

    got, want = _both(case)
    _close(got, want, WEIGHT_TOL)
    _close(got[0][idx], got[1][idx], WEIGHT_TOL)
    untouched = np.setdiff1d(np.arange(vocab), idx)
    np.testing.assert_array_equal(got[0][untouched], w0[untouched])


def test_sparse_sgd_lazy_update_false_is_dense():
    rng = np.random.RandomState(3)
    vocab, dim = 20, 3
    w0 = rng.randn(vocab, dim).astype(np.float32)
    gv = rng.randn(1, dim).astype(np.float32)

    def case(P):
        weight = P.nd.array(w0)
        grad = P.sp.row_sparse_array((gv, [4]), shape=(vocab, dim))
        opt = P.mx.optimizer.SGD(learning_rate=0.1, wd=0.1,
                                 lazy_update=False)
        opt.update(0, weight, grad, opt.create_state(0, weight))
        return weight.asnumpy()

    got, want = _both(case)
    _close(got, want, WEIGHT_TOL)
    np.testing.assert_allclose(got[0], w0[0] * (1 - 0.1 * 0.1), rtol=1e-5)


def test_end_to_end_sparse_embedding_training():
    """Five eager steps through ``opt.update``: the same losses and table
    in both packages, untouched rows bit-identical."""
    rng = np.random.RandomState(2)
    vocab, dim = 1000, 4
    table = rng.randn(vocab, dim).astype(np.float32) * 0.1
    target = rng.randn(2, 3, dim).astype(np.float32)
    ids = np.array([[1, 2, 3], [4, 5, 6]], np.float32)

    def case(P):
        emb = _embedding(P, vocab, dim, table)
        opt = P.mx.optimizer.SGD(learning_rate=0.2)
        state = opt.create_state(0, emb.weight.data())
        losses = []
        for _ in range(5):
            with P.ag.record():
                loss = ((emb(P.nd.array(ids)) - P.nd.array(target)) ** 2) \
                    .sum()
            loss.backward()
            opt.update(0, emb.weight.data(), emb.weight.grad(), state)
            losses.append(float(loss.asscalar()))
        return [np.array(losses), emb.weight.data().asnumpy()]

    got, want = _both(case)
    _close(got, want, WEIGHT_TOL)
    assert got[0][-1] < got[0][0] * 0.5
    untouched = np.setdiff1d(np.arange(vocab), np.arange(1, 7))
    np.testing.assert_array_equal(got[1][untouched], table[untouched])


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
])
def test_trainer_step_row_sparse_matches_jax(opt, params, monkeypatch):
    """``gluon.Trainer.step`` on ``Embedding(sparse_grad=True)`` + Dense,
    guard on: the grouped row-sparse rule against the JAX Trainer over 3
    steps, and nothing on the way reads the gradient's dense view."""
    rng = np.random.RandomState(4)
    table = rng.randn(60, 5).astype(np.float32) * 0.3
    dense_w = rng.randn(2, 5).astype(np.float32) * 0.3
    batches = [rng.randint(0, 60, size=(4, 3)).astype(np.float32)
               for _ in range(3)]

    def case(P):
        net = P.nn.HybridSequential()
        with net.name_scope():
            net.add(P.nn.Embedding(60, 5, sparse_grad=True))
            net.add(P.nn.Dense(2, in_units=5, flatten=False))
        net.initialize()
        net[0].weight.set_data(P.nd.array(table))
        net[1].weight.set_data(P.nd.array(dense_w))
        trainer = P.mx.gluon.Trainer(net.collect_params(), opt,
                                     dict(params))
        losses = []
        for x in batches:
            with P.ag.record():
                loss = (net(P.nd.array(x)) ** 2).sum()
            loss.backward()
            trainer.step(4)
            losses.append(float(loss.asscalar()))
        return [np.array(losses)] + [p.data().asnumpy()
                                      for p in trainer._params]

    def boom(self):
        raise AssertionError("the dense view of a row-sparse gradient "
                             "was read")

    with monkeypatch.context() as m:
        m.setattr(tsp.RowSparseNDArray, "_data",
                  property(boom, tsp.RowSparseNDArray._data.fset))
        with PORT.scope():
            got = case(PORT)
    want = case(JAX)
    _close(got, want, WEIGHT_TOL)


# -- kvstore -------------------------------------------------------------------

def test_kvstore_row_sparse_pull():
    table = np.arange(40, dtype=np.float32).reshape(10, 4)

    def case(P):
        kv = P.mx.kv.create("local")
        kv.init(0, P.nd.array(table))
        out = P.sp.zeros("row_sparse", (10, 4))
        kv.row_sparse_pull(0, out=out, row_ids=P.nd.array([2.0, 7.0, 2.0]))
        assert isinstance(out, P.sp.RowSparseNDArray)
        assert out.num_stored_rows == 2
        dense = P.nd.zeros((10, 4))
        kv.row_sparse_pull(0, out=dense, row_ids=P.nd.array([3.0]))
        return [out.indices.asnumpy(), out.data.asnumpy(), dense.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], table[[2, 7]])


def test_kvstore_row_sparse_pull_compact_store():
    """From a row-sparse store the rows come from the compact parts; the
    dense view is never built."""
    def case(P):
        kv = P.mx.kv.create("local")
        w = P.sp.row_sparse_array(
            (np.array([[1., 1.], [2., 2.], [3., 3.]], np.float32),
             [2, 7, 11]), shape=(1000, 2))
        kv.init("emb", w)
        out = P.sp.zeros("row_sparse", (1000, 2))
        hit = {"dense": False}
        orig = P.sp.RowSparseNDArray._data

        def boom(self):
            hit["dense"] = True
            return orig.fget(self)

        try:
            P.sp.RowSparseNDArray._data = property(boom, orig.fset)
            kv.row_sparse_pull("emb", out=out, row_ids=P.nd.array([7, 500]))
        finally:
            P.sp.RowSparseNDArray._data = orig
        assert not hit["dense"], "dense view materialized during pull"
        return [out.indices.asnumpy(), out.data.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[1], [[2., 2.], [0., 0.]])


def test_kvstore_row_sparse_pull_duplicate_numpy_ids():
    table = np.arange(40, dtype=np.float32).reshape(10, 4)

    def case(P):
        kv = P.mx.kv.create("local")
        kv.init(0, P.nd.array(table))
        out = P.sp.zeros("row_sparse", (10, 4))
        kv.row_sparse_pull(0, out=out,
                           row_ids=np.array([7, 2, 7, 7, 2], np.int64))
        out2 = P.sp.zeros("row_sparse", (10, 4))
        kv.row_sparse_pull(0, out=out2, row_ids=P.nd.array([2.0, 7.0]))
        assert out.num_stored_rows == 2
        np.testing.assert_array_equal(out.data.asnumpy(),
                                      out2.data.asnumpy())
        return [out.indices.asnumpy(), out.data.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gc_type,threshold", [("2bit", 0.5),
                                               ("fp16", 0.5)])
def test_compression_rowsparse_error_feedback_bitwise(gc_type, threshold):
    """2bit/fp16 on row-sparse gradients through the one-worker
    ``device`` store: each round's pull is BITWISE equal to a numpy
    oracle of the error-feedback recurrence in both packages, the
    residual stays compact (touched rows only), and rows owing residual
    are re-emitted on later rounds even when the new batch misses them
    (``tests/test_sparse.py``'s case)."""
    shape = (12, 2)
    rounds = [
        ([[0.7, -0.1], [0.2, 0.9]], [1, 4]),
        ([[0.4, 0.4]], [4]),               # row 1 only owes residual
        ([[0.3, -0.8], [0.05, 0.0]], [1, 9]),
    ]
    residual = {}  # oracle: row id -> np residual row

    def oracle(vals, ids):
        acc = {i: np.array(r, np.float32) for i, r in residual.items()}
        for r, i in zip(np.asarray(vals, np.float32), ids):
            acc[i] = acc.get(i, np.zeros(shape[1], np.float32)) + r
        out = {}
        residual.clear()
        for i, a in acc.items():
            if gc_type == "fp16":
                q = a.astype(np.float16).astype(np.float32)
            else:
                q = np.where(a >= threshold, np.float32(threshold),
                             np.where(a <= -threshold,
                                      np.float32(-threshold),
                                      np.float32(0.0)))
            out[i] = q
            res = a - q
            if np.any(res != 0):
                residual[i] = res
        return out

    wants, residuals = [], []
    for vals, ids in rounds:
        rows = oracle(vals, ids)
        want = np.zeros(shape, np.float32)
        for i, q in rows.items():
            want[i] = q
        wants.append(want)
        residuals.append({i: r.copy() for i, r in residual.items()})

    def case(P):
        kv = P.mx.kv.create("device")
        kv.set_gradient_compression({"type": gc_type,
                                     "threshold": threshold})
        kv.init("emb", P.nd.zeros(shape))
        touched = set()
        for (vals, ids), want, res in zip(rounds, wants, residuals):
            touched.update(ids)
            kv.push("emb", P.sp.row_sparse_array(
                (np.asarray(vals, np.float32), list(ids)), shape=shape))
            got = P.nd.zeros(shape)
            kv.pull("emb", out=got)
            np.testing.assert_array_equal(got.asnumpy(), want)
            gc = kv._compression
            if res:
                ids_kept, res_kept = gc._residual["emb"]
                np.testing.assert_array_equal(np.asarray(ids_kept),
                                              sorted(res))
                for row, i in zip(np.asarray(res_kept), sorted(res)):
                    np.testing.assert_array_equal(row, res[i])
                assert set(int(i) for i in np.asarray(ids_kept)) <= touched
            else:
                assert "emb" not in gc._residual
        return True

    assert _both(case) == [True, True]


# -- CSR compute ---------------------------------------------------------------

def _csr_problem(seed, rows=8, cols=12, density=0.3):
    rs = np.random.RandomState(seed)
    return ((rs.rand(rows, cols) < density)
            * rs.standard_normal((rows, cols))).astype(np.float32), rs


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_dense_matches_oracle(transpose_a):
    """dot(csr, dense) and dot(csr^T, dense), forward and the dense
    operand's gradient, against the JAX package and numpy."""
    a, rs = _csr_problem(0)
    rhs = rs.standard_normal((8 if transpose_a else 12, 5)).astype(
        np.float32)

    def case(P):
        r = P.nd.array(rhs)
        r.attach_grad()
        with P.ag.record():
            y = P.nd.sparse.dot(P.sp.csr_matrix(a), r,
                                transpose_a=transpose_a)
            loss = (y * y).sum()
        loss.backward()
        return [y.asnumpy(), r.grad.asnumpy()]

    got, want = _both(case)
    ref = a.T @ rhs if transpose_a else a @ rhs
    _close(got[0], want[0], OUT_TOL)
    _close(got[0], ref, OUT_TOL)
    _close(got[1], want[1], GRAD_TOL)


def test_csr_dot_dense_never_builds_the_dense_view(monkeypatch):
    """The kernel works from the parts: the CSR matrix's dense view is
    never read, forward or backward; the parts-level ``csr_dot_dense``
    matches the JAX package's."""
    import torch

    from mxnet_tpu.ndarray.sparse import csr_dot_dense as jdot

    a, rs = _csr_problem(1, 16, 300, 0.1)
    w = rs.standard_normal((300, 7)).astype(np.float32)
    with tmx.cpu():
        a_csr = tsp.csr_matrix(a)
        jc = jsp.csr_matrix(a)
        got = tsp.csr_dot_dense(*a_csr._parts(), torch.from_numpy(w), 16)
        want = np.asarray(jdot(jc._csr_data, jc._csr_indices,
                               jc._csr_indptr, jnp_array(w), 16))
        _close(got.numpy(), want, OUT_TOL)

        def boom(self):
            raise AssertionError("dense view of the CSR matrix")

        monkeypatch.setattr(tsp.CSRNDArray, "_data", property(boom))
        wn = tnd.array(w)
        wn.attach_grad()
        with tag.record():
            loss = (tnd.sparse.dot(a_csr, wn) ** 2).sum()
        loss.backward()
    _close(wn.grad.asnumpy(), a.T @ (2 * (a @ w)), GRAD_TOL)


def jnp_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_csr_dot_dispatch_covers_all_entry_points():
    a, rs = _csr_problem(4, 6, 9, 0.4)
    w = rs.standard_normal((9, 3)).astype(np.float32)

    def case(P):
        a_csr, w_nd = P.sp.csr_matrix(a), P.nd.array(w)
        with pytest.raises(Exception, match="shape mismatch"):
            P.nd.sparse.dot(a_csr, P.nd.array(w[:5]))
        return [P.nd.dot(a_csr, w_nd).asnumpy(), (a_csr @ w_nd).asnumpy()]

    got, want = _both(case)
    _close(got, want, OUT_TOL)
    _close(got[0], a @ w, OUT_TOL)


def test_csr_dot_positional_transpose_and_out():
    a, rs = _csr_problem(11, 6, 9, 0.4)
    x = rs.standard_normal((6, 3)).astype(np.float32)
    w = rs.standard_normal((9, 3)).astype(np.float32)

    def case(P):
        a_csr = P.sp.csr_matrix(a)
        t = P.nd.dot(a_csr, P.nd.array(x), True).asnumpy()
        buf = P.nd.zeros((6, 3))
        got = P.nd.dot(a_csr, P.nd.array(w), out=buf)
        assert got is buf
        with pytest.raises(Exception, match="sparse storage"):
            P.nd.cast_storage(P.nd.array(a), "csr", out=P.nd.zeros((6, 9)))
        return [t, buf.asnumpy()]

    got, want = _both(case)
    _close(got, want, OUT_TOL)
    _close(got, [a.T @ x, a @ w], OUT_TOL)


# -- cast_storage --------------------------------------------------------------

def test_cast_storage_real():
    rs = np.random.RandomState(2)
    dense = ((rs.rand(20, 6) < 0.2)
             * rs.standard_normal((20, 6))).astype(np.float32)

    def case(P):
        d_nd = P.nd.array(dense)
        as_csr = P.nd.cast_storage(d_nd, "csr")
        as_rs = P.nd.cast_storage(d_nd, "row_sparse")
        back = P.nd.cast_storage(as_csr, "default")
        assert isinstance(as_csr, P.sp.CSRNDArray)
        assert isinstance(as_rs, P.sp.RowSparseNDArray)
        assert not isinstance(back, P.sp.CSRNDArray)
        return [as_csr.asnumpy(), as_rs.num_stored_rows, as_rs.asnumpy(),
                back.asnumpy()]

    got, want = _both(case)
    assert got[1] == want[1] == int((dense != 0).any(1).sum())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cast_storage_preserves_dtype():
    def case(P):
        x = P.nd.array(np.arange(6).reshape(2, 3), dtype="int32")
        back = P.nd.cast_storage(P.nd.cast_storage(x, "csr"), "default")
        return back.asnumpy()

    got, want = _both(case)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, np.arange(6).reshape(2, 3))


# -- LibSVMIter ----------------------------------------------------------------

def test_libsvm_iter_yields_csr(tmp_path):
    path = str(tmp_path / "t.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:-1.0\n1 2:0.5 3:1.0\n")

    def case(P):
        it = P.mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                                batch_size=2)
        out = []
        for batch in it:
            x = batch.data[0]
            assert isinstance(x, P.sp.CSRNDArray)
            out += [x.asnumpy(), batch.label[0].asnumpy()]
        d = P.mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                               batch_size=2, stype="default")
        xd = next(iter(d)).data[0]
        assert not isinstance(xd, P.sp.CSRNDArray)
        return out + [xd.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], [[1.5, 0, 0, 2.0], [0, -1.0, 0, 0]])


def test_libsvm_iter_rejects_multilabel_shape(tmp_path):
    path = str(tmp_path / "t.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5\n")
    for P in (PORT, JAX):
        with P.scope():
            with pytest.raises(Exception, match="label_shape"):
                P.mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                                   batch_size=1, label_shape=(3,))
            it = P.mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                                    batch_size=1, label_shape=1)
            assert it.provide_label[0].shape == (1,)


# -- compact elementwise -------------------------------------------------------

def _pair(P):
    a = P.sp.row_sparse_array(
        (np.array([[1., 2.], [3., 4.]], np.float32), [1, 5]),
        shape=(100, 2))
    b = P.sp.row_sparse_array(
        (np.array([[10., 20.], [30., 40.]], np.float32), [5, 7]),
        shape=(100, 2))
    return a, b


def test_sparse_elemwise_compact():
    def case(P):
        a, b = _pair(P)
        s, m = P.sp.add(a, b), P.sp.elemwise_mul(a, b)
        r = P.sp.retain(a, P.nd.array([5, 60]))
        c = P.sp.row_sparse_array(
            (np.array([[9., 9.]], np.float32), [50]), shape=(100, 2))
        e = P.sp.elemwise_mul(a, c)
        d = P.sp.add(a, P.nd.ones((100, 2)))
        for x in (s, m, r, e):
            assert isinstance(x, P.sp.RowSparseNDArray)
        assert not isinstance(d, P.sp.RowSparseNDArray)
        return [s.indices.asnumpy(), s.asnumpy(), m.indices.asnumpy(),
                m.asnumpy(), r.indices.asnumpy(), r.data.asnumpy(),
                np.array(e.num_stored_rows), d.asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [1, 5, 7])
    np.testing.assert_array_equal(got[2], [5])
    assert int(got[6]) == 0


def test_sparse_elemwise_dispatch_and_tape_fallback():
    def case(P):
        a = P.sp.row_sparse_array(
            (np.array([[1., 2.]], np.float32), [3]), shape=(50, 2))
        b = P.sp.row_sparse_array(
            (np.array([[5., 6.]], np.float32), [3]), shape=(50, 2))
        s1, s2, m = P.nd.elemwise_add(a, b), a + b, P.nd.elemwise_mul(a, b)
        for x in (s1, s2, m):
            assert isinstance(x, P.sp.RowSparseNDArray)
        x = P.nd.ones((50, 2))
        x.attach_grad()
        with P.ag.record():
            y = P.sp.add(a.tostype("default") * 0 + x, a)
            loss = (y * y).sum()
        loss.backward()
        return [s2.asnumpy(), m.asnumpy(), x.grad.asnumpy()]

    got, want = _both(case)
    _close(got, want, GRAD_TOL)
    assert float(np.abs(got[2]).sum()) > 0


# -- serialisation -------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sparse_save_load_roundtrip(tmp_path, writer):
    """Compact records with their stype, and dense records beside them,
    written by one package and read by both."""
    import os

    p = str(tmp_path / "s.params")
    W = PORT if writer == "port" else JAX
    with W.scope():
        a = W.sp.row_sparse_array(
            (np.array([[1., 2.], [3., 4.]], np.float32), [5, 9000]),
            shape=(10000, 2))
        c = W.sp.csr_matrix(np.eye(4, dtype=np.float32))
        d = W.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        W.nd.save(p, {"a": a, "c": c, "d": d})
    assert os.path.getsize(p) < 4096     # a dense `a` alone is 80 KB

    def case(P):
        back = P.nd.load(p)
        assert isinstance(back["a"], P.sp.RowSparseNDArray)
        assert isinstance(back["c"], P.sp.CSRNDArray)
        assert back["a"].num_stored_rows == 2
        return [back["a"].indices.asnumpy(), back["a"].asnumpy(),
                back["c"].asnumpy(), back["d"].asnumpy()]

    got, want = _both(case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [5, 9000])
    np.testing.assert_array_equal(got[2], np.eye(4))


# -- the Gluon surface ---------------------------------------------------------

def test_parameter_stypes_and_row_sparse_data():
    for P in (PORT, JAX):
        with P.scope():
            p = P.mx.gluon.Parameter("w_weight", shape=(6, 2),
                                     stype="row_sparse",
                                     grad_stype="row_sparse")
            p.initialize()
            assert p.stype == "row_sparse"
            assert isinstance(p.grad(), P.sp.RowSparseNDArray)
            assert p.row_sparse_data(P.nd.array([1.0])).shape == (6, 2)
            assert len(p.list_row_sparse_data(P.nd.array([1.0]))) == 1
