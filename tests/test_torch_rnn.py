"""The recurrent path of the port against the JAX package's, on the CPU.

The same numpy inputs go through both packages, with the JAX weights
carried across by ``convert.load_gluon_params``: the fused ``RNN`` op in
every mode, bidirectional, LSTMP, sequence lengths and the state clip
(outputs, final states and the gradients with respect to data,
parameters and states); ``rnn_param_size`` and the packed layout; the
``LSTM``, ``GRU`` and ``RNN`` layers in both layouts with a deferred
``input_size``; every cell through ``unroll`` with and without
``valid_length``; the two contrib cells; and the slice as a whole:
``RNNModel`` (``examples/lstm_language_model.py``) trained three Adam
steps with clipping and a carried hidden state.  Forward at rtol 1e-4 /
atol 1e-5 (``tests/test_rnn.py``'s), gradients and trained weights at
rtol 2e-3 / atol 2e-4.  Inter-layer dropout (p > 0) is held by its rate,
scale, predict-time identity and seeding: Philox and threefry draw other
masks.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.contrib import rnn as jcrnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.tools import bench_lstm
from torch_one_thread import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
ROOT = Path(__file__).resolve().parents[1]
# the module: ``mxnet_tpu.ops`` binds the name ``rnn`` to the op itself
jrnn = importlib.import_module("mxnet_tpu.ops.rnn")


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


# -- the op ------------------------------------------------------------------

# (mode, bidirectional, projection_size, sequence lengths, clip, layers):
# every mode, each feature with and without the reverse direction; two
# layers where the second's input width matters (LSTMP, bidirectional)
OP_CASES = [
    ("lstm", False, None, False, False, 1),
    ("lstm", True, 4, True, True, 2),
    ("gru", False, None, True, False, 2),
    ("gru", True, None, False, False, 1),
    ("rnn_tanh", True, None, True, False, 1),
    ("rnn_relu", False, None, False, False, 1),
]
T, B, I, H = 6, 3, 5, 7


def _op_inputs(mode, bi, proj, seq, clip, L, seed):
    rs = np.random.RandomState(seed)
    dirs = 2 if bi else 1
    rec = proj or H
    n = jrnn.rnn_param_size(mode, I, H, L, bi, proj)
    arrays = [rs.randn(T, B, I).astype(np.float32),
              (rs.randn(n) * 0.3).astype(np.float32),
              (rs.randn(L * dirs, B, rec) * 0.5).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rs.randn(L * dirs, B, H) * 0.5).astype(np.float32))
    kwargs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
                  projection_size=proj, state_outputs=True)
    if clip:
        kwargs.update(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.3)
    lens = np.array([T, 3, 1], np.int32) if seq else None
    if seq:
        kwargs.update(use_sequence_length=True)
    shapes = [(T, B, rec * dirs), (L * dirs, B, rec)] + (
        [(L * dirs, B, H)] if mode == "lstm" else [])
    cots = [rs.randn(*s).astype(np.float32) for s in shapes]
    return arrays, lens, kwargs, cots


def _jax_op(arrays, lens, kwargs, cots):
    """The JAX op's outputs and its gradients with respect to data,
    parameters and states, jitted (eager JAX compiles op by op)."""
    import jax
    import jax.numpy as jnp

    def f(*args):
        outs = jrnn.rnn(*args[:3], args[3] if len(args) > 3 else None,
                        sequence_length=None if lens is None
                        else jnp.asarray(lens), _is_training=False,
                        **kwargs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(arrays))), has_aux=True))(*arrays)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_op(arrays, lens, kwargs, cots):
    args = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = trnn.rnn(*args[:3], args[3] if len(args) > 3 else None,
                    sequence_length=None if lens is None
                    else torch.from_numpy(lens), _is_training=False,
                    **kwargs)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    loss.backward()
    return ([o.detach().numpy() for o in outs],
            [a.grad.numpy() for a in args])


@pytest.mark.parametrize("mode,bi,proj,seq,clip,L", OP_CASES)
def test_rnn_op_matches_jax(mode, bi, proj, seq, clip, L):
    case = _op_inputs(mode, bi, proj, seq, clip, L, seed=len(mode) + bi)
    want, wgrads = _jax_op(*case)
    got, grads = _port_op(*case)
    for g, w, name in zip(got, want, ("out", "h", "c")):
        _close(g, w, FWD, name)
    for g, w, name in zip(grads, wgrads, ("data", "params", "state",
                                          "cell")):
        _close(g, w, GRAD, "d" + name)
    if seq:
        # padded steps emit zeros (the forward direction's half)
        assert not got[0][3:, 1, :proj or H].any()
    if clip:
        assert got[2].min() >= -0.2 and got[2].max() <= 0.3


def test_rnn_op_through_nd_and_the_mode():
    """``mx.nd.RNN`` on NDArrays: the wrapper injects the mode and a
    generator; inside ``autograd.record()`` the op is on the tape."""
    arrays, _, kwargs, _ = _op_inputs("gru", False, None, False, False, 2,
                                      0)
    with tmx.cpu():
        nds = [tnd.array(a) for a in arrays]
        nds[0].attach_grad()
        with tag.record():
            out, h = tnd.RNN(*nds, None, p=0.5, **kwargs)
            total = out.sum()
        total.backward()
        pred, _ = tnd.RNN(*nds, None, p=0.5, **kwargs)
    ref = trnn.rnn(*[torch.from_numpy(a) for a in arrays], None,
                   _is_training=False, **kwargs)[0]
    np.testing.assert_allclose(pred.asnumpy(), ref.numpy(), rtol=1e-6)
    assert not np.allclose(out.asnumpy(), pred.asnumpy())
    assert np.abs(nds[0].grad.asnumpy()).sum() > 0


@pytest.mark.parametrize("mode,bi,proj", [("lstm", False, None),
                                          ("lstm", True, 3),
                                          ("gru", True, None),
                                          ("rnn_relu", False, None)])
def test_param_size_and_packed_layout(mode, bi, proj):
    for layers in (1, 3):
        n = trnn.rnn_param_size(mode, 5, 4, layers, bi, proj)
        assert n == jrnn.rnn_param_size(mode, 5, 4, layers, bi, proj)
        flat = np.arange(n, dtype=np.float32)
        dirs = 2 if bi else 1
        tw, tb = trnn._unpack_params(torch.from_numpy(flat), mode, 5, 4,
                                     layers, dirs, proj)
        jw, jb = jrnn._unpack_params(flat, mode, 5, 4, layers, dirs, proj)
        for tp, jp in zip(tw + tb, jw + jb):
            for t, j in zip(tp, jp):
                assert (t is None) == (j is None)
                if t is not None:
                    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- the layers ----------------------------------------------------------------

def _params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _grads_of(block):
    return {k.split("_", 1)[1]: p.grad().asnumpy()
            for k, p in block.collect_params().items()}


# (layer, layout, arguments, states given): each layer in each layout,
# a deferred input_size throughout; two layers, both directions and LSTMP
# in one case (the packing of a second layer's weights)
LAYER_CASES = [
    ("LSTM", "TNC", dict(num_layers=2, bidirectional=True,
                         projection_size=4), True),
    ("LSTM", "NTC", dict(), False),
    ("GRU", "NTC", dict(bidirectional=True), True),
    ("RNN", "TNC", dict(activation="tanh"), True),
    ("RNN", "NTC", dict(activation="relu"), False),
]


def _layer_run(nd, ag, net, x, states, cot):
    xa = nd.array(x)
    xa.attach_grad()
    st = None if states is None else [nd.array(s) for s in states]
    with ag.record():
        res = net(xa) if st is None else net(xa, st)
        out = res if st is None else res[0]
        loss = (out * nd.array(cot)).sum()
        if st is not None:
            for s in res[1]:
                loss = loss + (s * s).sum()
    loss.backward()
    new = [] if st is None else [s.asnumpy() for s in res[1]]
    return out.asnumpy(), new, xa.grad.asnumpy(), _grads_of(net)


@pytest.mark.parametrize("kind,layout,kw,with_states", LAYER_CASES)
def test_layer_matches_jax(kind, layout, kw, with_states):
    rs = np.random.RandomState(3)
    x = rs.randn(*((5, 3, 4) if layout == "TNC" else (3, 5, 4))).astype(
        np.float32)
    mx.random.seed(1)
    # the JAX layer is built at its input width (no first pass to infer
    # it, one XLA program compiled, not one an op); the port's is deferred
    jnet = getattr(jgluon.rnn, kind)(6, layout=layout, input_size=4, **kw)
    jnet.initialize(mx.init.Xavier())
    jnet.hybridize()
    with tmx.cpu():
        tnet = getattr(tgluon.rnn, kind)(6, layout=layout, **kw)
        tnet.initialize()
    assert all(p.shape[1] == 0 for k, p in tnet.collect_params().items()
               if k.endswith("l0_i2h_weight"))
    states = None
    if with_states:
        states = [(rs.randn(*info["shape"]) * 0.5).astype(np.float32)
                  for info in jnet.state_info(3)]
    dirs = 2 if kw.get("bidirectional") else 1
    width = kw.get("projection_size", 6) * dirs
    cot = rs.randn(*(x.shape[:2] + (width,))).astype(np.float32)
    convert.load_gluon_params(tnet, _params(jnet))
    want = _layer_run(jnd, jag, jnet, x, states, cot)
    with tmx.cpu():
        got = _layer_run(tnd, tag, tnet, x, states, cot)
    assert len(got[1]) == (len(jnet.state_info()) if with_states else 0)
    _close(got[0], want[0], FWD, "out")
    for g, w in zip(got[1], want[1]):
        _close(g, w, FWD, "states")
    _close(got[2], want[2], GRAD, "dx")
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _close(got[3][k], want[3][k], GRAD, k)


def test_layer_begin_state_and_repr():
    with tmx.cpu():
        net = tgluon.rnn.LSTM(8, num_layers=2, bidirectional=True,
                              projection_size=5, input_size=3)
        st = net.begin_state(batch_size=4)
        deferred = tgluon.rnn.LSTM(8, num_layers=2, projection_size=5)
        deferred.initialize()
        out = deferred(tnd.ones((4, 2, 3)))
    assert out.shape == (4, 2, 5)
    assert deferred.l0_i2h_weight.shape == (32, 3)
    assert deferred.l1_i2h_weight.shape == (32, 5)   # the projected width
    assert [s.shape for s in st] == [(4, 4, 5), (4, 4, 8)]
    assert str(st[0].context) == "cpu(0)"
    assert repr(net) == repr(jgluon.rnn.LSTM(
        8, num_layers=2, bidirectional=True, projection_size=5,
        input_size=3))
    with pytest.raises(tmx.MXNetError):
        tgluon.rnn.GRU(4, projection_size=2)


# -- the cells -----------------------------------------------------------------

LEAF_CELLS = (jgluon.rnn.RNNCell, jgluon.rnn.LSTMCell, jgluon.rnn.GRUCell,
              jcrnn.Conv2DLSTMCell)


def _hybridize_leaves(cell):
    """Hybridize the JAX package's parameterised cells (one XLA program a
    step, not one an op); the modifier cells keep Python state across
    steps and stay eager."""
    if isinstance(cell, LEAF_CELLS):
        cell.hybridize()
    for c in cell._children.values():
        _hybridize_leaves(c)


def _cell_pair(make, x, load_into):
    """The JAX cell built at its input widths (``make(r, True)``), the
    port's deferred (``make(r, False)``), the JAX weights loaded into
    it."""
    mx.random.seed(2)
    jcell = make(jgluon.rnn, True)
    jcell.initialize(mx.init.Xavier())
    _hybridize_leaves(jcell)
    with tmx.cpu():
        tcell = make(tgluon.rnn, False)
        tcell.initialize()
    for jc, tc in zip(load_into(jcell), load_into(tcell)):
        convert.load_gluon_params(tc, _params(jc))
    return jcell, tcell


def _itself(cell):
    return [cell]


def _bases(cell):
    return [cell.base_cell]


def _children(cell):
    """Cells made outside a name scope take global names: load each
    child by its own prefix."""
    return list(cell._children.values())


def _seq(r, sized):
    s = r.SequentialRNNCell()
    s.add(r.LSTMCell(5, input_size=4 if sized else 0))
    s.add(r.DropoutCell(0.5))
    s.add(r.GRUCell(4, input_size=5 if sized else 0))
    return s


def _residual_zoneout(r, sized):
    base = r.LSTMCell(4, input_size=4 if sized else 0)
    return r.ResidualCell(r.ZoneoutCell(base, 0.3, 0.3))


def _base_of_base(cell):
    return [cell.base_cell.base_cell]


# (make(package's rnn, sized), the blocks to load weights into, output
# width); every cell class is in one of them
CELLS = {
    "rnn_tanh": (lambda r, sized: r.RNNCell(6, input_size=4 if sized
                                            else 0), _itself, 6),
    "sequential_lstm_dropout_gru": (_seq, _children, 4),
    "residual_zoneout_lstm": (_residual_zoneout, _base_of_base, 4),
    "bidirectional_lstm_gru": (
        lambda r, sized: r.BidirectionalCell(
            r.LSTMCell(4, input_size=4 if sized else 0),
            r.GRUCell(3, input_size=4 if sized else 0)), _children, 7),
}


def _unroll_run(nd, ag, cell, x, valid, cot):
    xa = nd.array(x)
    xa.attach_grad()
    kw = {} if valid is None else {"valid_length": nd.array(valid)}
    with ag.record(train_mode=False):
        outs, states = cell.unroll(x.shape[1], xa, layout="NTC",
                                   merge_outputs=True, **kw)
        loss = (outs * nd.array(cot)).sum()
        for s in states:
            loss = loss + (s * s).sum()
    loss.backward()
    return outs.asnumpy(), [s.asnumpy() for s in states], xa.grad.asnumpy()


def _cell_agrees(jcell, tcell, x, valid, cot):
    want = _unroll_run(jnd, jag, jcell, x, valid, cot)
    with tmx.cpu():
        got = _unroll_run(tnd, tag, tcell, x, valid, cot)
    _close(got[0], want[0], FWD, "outputs")
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        _close(g, w, FWD, "states")
    _close(got[2], want[2], GRAD, "dx")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name):
    """Each cell unrolled over NTC inputs, without and with
    ``valid_length`` (predict mode: DropoutCell and ZoneoutCell pass
    through)."""
    make, load_into, width = CELLS[name]
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 4).astype(np.float32)   # NTC
    jcell, tcell = _cell_pair(make, x, load_into)
    cot = rs.randn(3, 5, width).astype(np.float32)
    for valid in (None, np.array([5, 2, 4], np.float32)):
        _cell_agrees(jcell, tcell, x, valid, cot)


def test_cell_steps_on_tensors():
    """A cell called with tensors runs on them (Gluon's F path); unroll
    makes its begin state on the inputs' device."""
    with tmx.cpu():
        cell = tgluon.rnn.LSTMCell(4, input_size=3)
        cell.initialize()
        x = torch.randn(2, 5, 3)
        outs, states = cell.unroll(5, x, layout="NTC", merge_outputs=True)
        ref, rstates = cell.unroll(5, tnd.array(x.numpy()), layout="NTC",
                                   merge_outputs=True)
    assert isinstance(outs, torch.Tensor) and outs.shape == (2, 5, 4)
    np.testing.assert_allclose(outs.detach().numpy(), ref.asnumpy(),
                               rtol=1e-6)


def test_contrib_cells_match_jax():
    """Conv2DLSTMCell on (N, T, C, H, W), and VariationalDropoutCell at
    rate 0 (its base cell), against the JAX package."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 3, 6, 5).astype(np.float32)
    jcell, tcell = _cell_pair(
        lambda r, _: (jcrnn if r is jgluon.rnn else tcrnn).Conv2DLSTMCell(
            (3, 6, 5), 4), x, _itself)
    _cell_agrees(jcell, tcell, x, None,
                 rs.randn(2, 3, 4, 6, 5).astype(np.float32))
    x = rs.randn(3, 5, 4).astype(np.float32)
    jcell, tcell = _cell_pair(
        lambda r, sized: (jcrnn if r is jgluon.rnn else tcrnn)
        .VariationalDropoutCell(r.GRUCell(6, input_size=4 if sized else 0)),
        x, _bases)
    _cell_agrees(jcell, tcell, x, None, rs.randn(3, 5, 6).astype(np.float32))


def test_variational_dropout_keeps_one_mask_an_unroll():
    """At rate 0.5 one input mask serves every step of an unroll, and the
    next unroll draws a new one."""
    x = np.random.RandomState(6).randn(3, 5, 4).astype(np.float32)
    with tmx.cpu():
        tmx.random.seed(0)
        base = tgluon.rnn.GRUCell(6, input_size=4)
        base.initialize()
        cell = tcrnn.VariationalDropoutCell(base, drop_inputs=0.5)
        xs = tnd.array(x)
        outs, _ = cell.unroll(5, xs, layout="NTC", merge_outputs=True)
        mask = cell._input_mask.numpy()
        assert set(np.unique(mask)) == {0.0, 2.0}
        base._modified = False
        ref, _ = base.unroll(5, tnd.array(x * mask[:, None, :]),
                             layout="NTC", merge_outputs=True)
        base._modified = True
        np.testing.assert_allclose(outs.asnumpy(), ref.asnumpy(),
                                   rtol=1e-6)
        cell.unroll(5, xs, layout="NTC")
        assert not np.array_equal(cell._input_mask.numpy(), mask)


# -- inter-layer dropout ---------------------------------------------------------

def _dropout_probe(p, training, gen=None):
    """A 2-layer rnn_relu whose output is layer 1's output after the
    inter-layer dropout: layer 1 positive (Wh = 0), layer 2 the identity
    (Wx = I, Wh = 0, no bias); returns (layer 1's output, the op's)."""
    H2 = 64
    rs = np.random.RandomState(8)
    x = np.abs(rs.randn(20, 16, 3)).astype(np.float32) + 0.1
    wx1 = np.abs(rs.randn(H2, 3)).astype(np.float32) + 0.1
    parts = [wx1.ravel(), np.zeros(H2 * H2, np.float32),
             np.eye(H2, dtype=np.float32).ravel(),
             np.zeros(H2 * H2, np.float32), np.zeros(4 * H2, np.float32)]
    params = torch.from_numpy(np.concatenate(parts))
    state = torch.zeros(2, 16, H2)
    out = trnn.rnn(torch.from_numpy(x), params, state, state_size=H2,
                   num_layers=2, mode="rnn_relu", p=p,
                   _is_training=training, _key=gen)
    return torch.from_numpy(x @ wx1.T).numpy(), out.numpy()


def test_inter_layer_dropout_rate_scale_and_seed():
    pre, out = _dropout_probe(0.5, True, torch.Generator().manual_seed(3))
    ratio = out / pre
    kept = ratio > 0
    np.testing.assert_allclose(ratio[kept], 2.0, rtol=1e-6)
    assert abs(kept.mean() - 0.5) < 0.03, kept.mean()
    _, again = _dropout_probe(0.5, True, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(out, again)
    _, other = _dropout_probe(0.5, True, torch.Generator().manual_seed(4))
    assert not np.array_equal(out, other)
    _, pred = _dropout_probe(0.5, False)
    np.testing.assert_allclose(pred, pre, rtol=1e-6)
    # never after the last layer: a 1-layer op ignores p
    x = torch.randn(4, 2, 3)
    n = trnn.rnn_param_size("gru", 3, 5)
    params = torch.randn(n) * 0.3
    a = trnn.rnn(x, params, torch.zeros(1, 2, 5), state_size=5,
                 mode="gru", p=0.9, _key=torch.Generator().manual_seed(0))
    b = trnn.rnn(x, params, torch.zeros(1, 2, 5), state_size=5,
                 mode="gru", p=0.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layer_dropout_follows_the_mode_and_the_seed():
    with tmx.cpu():
        net = tgluon.rnn.LSTM(8, num_layers=2, dropout=0.5, input_size=6)
        net.initialize()
        x = tnd.array(np.random.RandomState(9).randn(4, 2, 6))
        with tag.train_mode():
            tmx.random.seed(5)
            a = net(x).asnumpy()
            b = net(x).asnumpy()
            tmx.random.seed(5)
            c = net(x).asnumpy()
        assert not np.allclose(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(net(x).asnumpy(), net(x).asnumpy())


# -- the slice: RNNModel trained three Adam steps ----------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "lstm_language_model", ROOT / "examples" / "lstm_language_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train(pkg, ag, nd, model, data, vocab, steps):
    trainer = pkg.gluon.Trainer(model.collect_params(), "adam",
                                {"learning_rate": 0.01,
                                 "clip_gradient": 0.25})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    T, Bn = 8, data.shape[1]
    hidden = model.begin_state(batch_size=Bn, ctx=pkg.cpu())
    history = []
    for i in range(steps):
        x = nd.array(data[i * T:(i + 1) * T])
        y = nd.array(data[i * T + 1:(i + 1) * T + 1])
        hidden = [h.detach() for h in hidden]
        with ag.record():
            out, hidden = model(x, hidden)
            ls = loss_fn(out.reshape((-1, vocab)), y.reshape((-1,)))
        ls.backward()
        trainer.step(T * Bn)
        history.append((ls.asnumpy(), _params(model),
                        [h.asnumpy() for h in hidden]))
    return history


def test_lstm_lm_slice_matches_jax():
    vocab, steps = 50, 3
    ex = _jax_example()
    data = bench_lstm.batchify(bench_lstm.corpus(vocab, (steps * 8 + 1) * 4),
                               4).astype(np.float32)
    mx.random.seed(11)
    jmodel = ex.RNNModel(vocab, 16, 32, 2, dropout=0.0)
    jmodel.initialize(init=mx.init.Xavier())
    jmodel.hybridize()      # its children: one XLA program each
    with tmx.cpu():
        tmodel = bench_lstm.RNNModel(vocab, 16, 32, 2, dropout=0.0)
        tmodel.initialize(init=tmx.init.Xavier())
    convert.load_gluon_params(tmodel, _params(jmodel))
    want = _train(mx, jag, jnd, jmodel, data, vocab, steps)
    with tmx.cpu():
        got = _train(tmx, tag, tnd, tmodel, data, vocab, steps)
    strip = (lambda d: {k.split("_", 1)[1]: v for k, v in d.items()})
    for i, ((gl, gp, gh), (wl, wp, wh)) in enumerate(zip(got, want)):
        _close(gl, wl, FWD, f"loss {i}")
        gp, wp = strip(gp), strip(wp)
        assert set(gp) == set(wp)
        for k in wp:
            _close(gp[k], wp[k], GRAD, f"step {i} {k}")
        for g, w in zip(gh, wh):
            _close(g, w, GRAD, f"hidden {i}")
    assert got[-1][0].mean() < got[0][0].mean()


def test_bench_lstm_runs_on_the_host():
    res = bench_lstm.run(vocab=30, embed=8, hidden=12, layers=2, bptt=5,
                         batch=3, dropout=0.5, steps=3, warmup=1,
                         device="cpu")
    assert res["backend"] == "cpu" and res["steps_timed"] == 3
    assert res["ms_min"] <= res["ms_per_step"] <= res["ms_max"]
    assert "busy_share" not in res and "peak_mem_gib" not in res
    assert np.isfinite(res["loss_last"])
    toks = bench_lstm.corpus(100, 1000, successors=4)
    nxt = {}
    for a, b in zip(toks[:-1], toks[1:]):
        nxt.setdefault(a, set()).add(b)
    assert max(len(v) for v in nxt.values()) <= 4
