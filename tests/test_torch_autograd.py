"""Autograd parity: ``mxnet_tpu_torch.autograd`` against
``mxnet_tpu.autograd``.

Each case of ``tests/test_autograd.py:9-223`` (and ``Function``) runs the
same numpy inputs through both packages (the port under ``with
mx.cpu():``) and compares every gradient within rtol 2e-3 / atol 2e-4
(ROADMAP's gradient tolerance); MXNet's semantics that differ from
torch's (``grad_req`` write/add applied once per backward, non-scalar
heads seeded with ones, a head off the tape, the tape dropped unless
``retain_graph``) are held in both.  ``SoftmaxOutput`` and the hybridized
block case wait for ``ops/nn`` and Gluon.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

TOL = dict(rtol=2e-3, atol=2e-4)
RNG = np.random.default_rng(5)
A23 = RNG.random((2, 3)).astype(np.float32)
W34 = RNG.random((3, 4)).astype(np.float32)
X46 = RNG.random((4, 6)).astype(np.float32)


def both(case):
    want = case(jmx, jnd, jag)
    with tmx.cpu():
        got = case(tmx, tnd, tag)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g.asnumpy()), np.asarray(w.asnumpy())
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g, w)
        np.testing.assert_allclose(g, w, err_msg=f"{case.__name__}[{i}]",
                                   **TOL)
    return got


def _var(nd, v, req="write"):
    x = nd.array(v)
    x.attach_grad(grad_req=req)
    return x


def test_simple_chain_multi_input():
    def case(mx, nd, ag):
        x, y0 = _var(nd, [1.0, 2.0, 3.0]), _var(nd, [0.5, -0.5])
        a, b = _var(nd, [1.0, 2.0]), _var(nd, [3.0, 4.0])
        with ag.record():
            y = x * x
            z = nd.exp(y0) * 2 + y0
            c = a * b + a
        for h in (y, z, c):
            h.backward()
        return [x.grad, y0.grad, a.grad, b.grad]

    both(case)


def test_dot_grad_and_head_grad():
    def case(mx, nd, ag):
        a, w = nd.array(A23), _var(nd, W34)
        x = _var(nd, [1.0, 2.0])
        with ag.record():
            loss = nd.sum(nd.dot(a, w))
            y = 3 * x
        loss.backward()
        y.backward(nd.array([10.0, 100.0]))
        return [w.grad, x.grad]

    both(case)


def test_grad_req_add_and_write():
    def case(mx, nd, ag):
        x = _var(nd, [2.0], "add")
        w = _var(nd, [2.0], "write")
        for _ in range(3):
            with ag.record():
                y = x * x + w * w * w
            y.backward()
        return [x.grad, w.grad]

    got = both(case)
    assert float(got[0].asnumpy()[0]) == 12.0


def test_detach_stop_gradient_pause():
    def case(mx, nd, ag):
        x, s, p = _var(nd, [2.0]), _var(nd, [3.0]), _var(nd, [1.0])
        with ag.record():
            y = x * x
            z = y.detach() * x
            u = nd.stop_gradient(s * s) + s
            with ag.pause():
                _ = p * 10
            q = p * 2
        for h in (z, u, q):
            h.backward()
        return [x.grad, s.grad, p.grad]

    both(case)


def test_recording_flags():
    for ag in (jag, tag):
        assert not ag.is_recording()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.predict_mode():
                assert not ag.is_training() and ag.is_recording()
            with ag.pause():
                assert not ag.is_recording()
        with ag.train_mode():
            assert ag.is_training()
        assert not ag.is_recording() and not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True


def test_getitem_and_multi_output_grad():
    def case(mx, nd, ag):
        x = _var(nd, [1.0, 2.0, 3.0, 4.0])
        m = _var(nd, X46)
        with ag.record():
            y = x[1:3] * 2
            a, b = nd.split(m, num_outputs=2, axis=1)
            loss = nd.sum(a) + nd.sum(b * 2)
        y.backward()
        loss.backward()
        return [x.grad, m.grad]

    both(case)


def test_autograd_grad_api_and_mark_variables():
    def case(mx, nd, ag):
        x = _var(nd, [2.0])
        with ag.record():
            y = x * x * x
        (g,) = ag.grad([y], [x])
        v = nd.array([1.0, 1.0])
        gv = nd.zeros((2,))
        ag.mark_variables([v], [gv])
        with ag.record():
            s = nd.sum(v * 5)
        s.backward()
        return [g, gv, x.grad]

    got = both(case)
    assert float(got[2].asnumpy()[0]) == 0.0   # grad() leaves .grad alone


def test_non_scalar_heads_and_variable_head():
    def case(mx, nd, ag):
        x = _var(nd, X46)
        y = _var(nd, [1.0, 2.0])
        with ag.record():
            h = nd.exp(x) * x           # (4, 6) head: seeded with ones
        h.backward()
        y.backward()                    # a variable head: its grad is ones
        z = _var(nd, [3.0])
        ag.backward([z], [nd.array([5.0])])
        return [x.grad, y.grad, z.grad]

    both(case)


def test_head_off_tape_raises_and_tape_dropped():
    for mx, nd, ag, ctx in ((jmx, jnd, jag, None),
                            (tmx, tnd, tag, tmx.cpu())):
        with (ctx or _null()):
            with pytest.raises(mx.MXNetError, match="not on the tape"):
                nd.array([1.0]).backward()
            x = _var(nd, [2.0])
            with ag.record():
                y = x * x
            y.backward()
            with pytest.raises(mx.MXNetError, match="not on the tape"):
                y.backward()            # the tape is gone
            with ag.record():
                y = x * x
            y.backward(retain_graph=True)
            y.backward()                # retained once: a second pass works
            np.testing.assert_allclose(x.grad.asnumpy(), [4.0])


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_custom_function():
    def case(mx, nd, ag):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self._saved
                return dy * y * (1 - y)

        class MulAdd(ag.Function):     # two inputs, two outputs
            def forward(self, a, b):
                return a * b, a + b

            def backward(self, da, db):
                return da * 3 + db, da * 2 + db

        x = _var(nd, [0.0, 1.0])
        a, b = _var(nd, [2.0]), _var(nd, [3.0])
        with ag.record():
            y = Sigmoid()(x)
            p, q = MulAdd()(a, b)
            loss = nd.sum(p * 2) + nd.sum(q)
        y.backward()
        loss.backward()
        return [y, x.grad, a.grad, b.grad]

    both(case)


def test_second_and_third_order():
    def case(mx, nd, ag):
        x = _var(nd, [1.0, 2.0, 3.0])
        s = _var(nd, [0.3, -0.7, 1.2])
        t = _var(nd, [0.5, 1.5])
        with ag.record():
            y = x * x * x
            dy = ag.grad(y, x, create_graph=True)
            z = nd.sin(s)
            dz = ag.grad(z, s, create_graph=True)
            zz = (dz * dz).sum()
            w = t * t * t * t
            d1 = ag.grad(w, t, create_graph=True)
            d2 = ag.grad(d1, t, create_graph=True)
        dy.backward()
        zz.backward()
        d2.backward()
        return [dy, x.grad, s.grad, d1, d2, t.grad]

    both(case)


def test_create_graph_multivar():
    def case(mx, nd, ag):
        x, w = _var(nd, [1.0, 2.0]), _var(nd, [3.0, 4.0])
        with ag.record():
            y = (x * x * w).sum()
            dx, dw = ag.grad(y, [x, w], create_graph=True)
            z = (dx * dx).sum() + (dw * dw).sum()
        z.backward()
        return [dx, dw, x.grad, w.grad]

    both(case)


def test_inplace_in_record_and_update_outside():
    """``+=`` inside record keeps the graph; an update outside record
    (the SGD step) leaves the variable a variable."""
    def case(mx, nd, ag):
        x = _var(nd, [1.0, 2.0])
        with ag.record():
            y = x * 3
            y += x * x
        y.backward()
        g1 = x.grad.copy()
        x[:] = x - 0.1 * x.grad
        with ag.record():
            z = (x * x).sum()
        z.backward()
        return [g1, x, x.grad]

    both(case)
