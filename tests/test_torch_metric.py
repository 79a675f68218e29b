"""The port's ``mx.metric`` against the JAX package's, on the CPU: the same
numpy labels and predictions through both, as NDArrays (Accuracy and
TopKAccuracy count on the device) and as numpy arrays (the host path), over
two updates; ``get``, ``get_global`` and ``get_name_value`` agree within
rtol 2e-4 / atol 2e-5.  Then ``create`` by name, alias, list and callable,
``mx.metric.np``, ``get_config``, ``reset_local`` and the Loss metric's
non-finite accounting."""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _batches(kind, seed):
    """Two (labels, preds) batches for a metric of ``kind``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "class":
            pred = _softmax(rng.standard_normal((12, 5)))
            label = rng.randint(0, 5, 12).astype(np.float32)
        elif kind == "binary":
            pred = _softmax(rng.standard_normal((12, 2)))
            label = rng.randint(0, 2, 12).astype(np.float32)
        elif kind == "binary1d":
            pred = rng.uniform(0, 1, 12).astype(np.float32)
            label = rng.randint(0, 2, 12).astype(np.float32)
        elif kind == "seq":
            pred = _softmax(rng.standard_normal((3, 4, 6)))
            label = rng.randint(0, 6, (3, 4)).astype(np.float32)
            label[0, 0] = 0
        elif kind == "argmax":
            pred = rng.randint(0, 5, 12).astype(np.float32)
            label = rng.randint(0, 5, 12).astype(np.float32)
        else:   # regression
            pred = rng.standard_normal((12, 1)).astype(np.float32)
            label = (pred[:, 0] + 0.3 * rng.standard_normal(12)).astype(
                np.float32)
        out.append((label, pred))
    return out


CASES = [
    ("acc", {}, "class"),
    ("acc", {}, "argmax"),
    ("top_k_accuracy", {"top_k": 3}, "class"),
    ("f1", {}, "binary"),
    ("f1", {"average": "micro"}, "binary1d"),
    ("mcc", {}, "binary"),
    ("mcc", {"average": "micro"}, "binary"),
    ("perplexity", {"ignore_label": 0}, "seq"),
    ("perplexity", {}, "class"),
    ("ce", {}, "class"),
    ("nll_loss", {}, "class"),
    ("mae", {}, "reg"),
    ("mse", {}, "reg"),
    ("rmse", {}, "reg"),
    ("pearsonr", {}, "reg"),
    ("loss", {}, "reg"),
    ("caffe", {}, "reg"),
]


def _feed(pkg, nd, name, kw, batches, as_nd):
    m = pkg.metric.create(name, **kw)
    for label, pred in batches:
        if as_nd:
            label, pred = nd.array(label), nd.array(pred)
        m.update([label], [pred])
    local = m.get()
    m.reset_local()
    return local, m.get_global(), m.get_name_value()


@pytest.mark.parametrize("as_nd", [True, False], ids=["ndarray", "numpy"])
@pytest.mark.parametrize("name,kw,kind", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(CASES)])
def test_metric_matches_jax(name, kw, kind, as_nd):
    batches = _batches(kind, seed=len(name) + len(kw))
    want = _feed(jmx, jnd, name, kw, batches, as_nd)
    with cpu():
        got = _feed(tmx, tnd, name, kw, batches, as_nd)
    (gn, gv), (ggn, ggv), gnv = got
    (wn, wv), (wgn, wgv), wnv = want
    assert gn == wn and ggn == wgn
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ggv, wgv, rtol=RTOL, atol=ATOL)
    assert [n for n, _ in gnv] == [n for n, _ in wnv]


def test_accuracy_counts_on_the_device():
    """Accuracy over NDArrays reads back one count, not the logits: the
    device count equals the host path's."""
    from mxnet_tpu_torch import metric

    (label, pred), _ = _batches("class", 3)
    with cpu():
        dev = metric._device_correct_count(
            "acc", tnd.array(pred)._data, tnd.array(label)._data, axis=1,
            need_argmax=True)
    assert dev.dim() == 0
    assert int(dev) == int((pred.argmax(axis=1) == label).sum())


def test_composite_custom_and_create():
    batches = _batches("class", 5)
    res = []
    for pkg, nd in ((jmx, jnd), (tmx, tnd)):
        with cpu():
            comp = pkg.metric.create(["acc", "perplexity"])
            comp.add(pkg.metric.np(
                lambda label, pred: float((pred.argmax(1) == label).mean()),
                name="mine"))
            custom = pkg.metric.create(
                lambda label, pred: (float(np.abs(pred).sum()), 2))
            for label, pred in batches:
                comp.update([nd.array(label)], [nd.array(pred)])
                custom.update([nd.array(label)], [nd.array(pred)])
            plain = pkg.metric.create(["acc", "perplexity"])
            res.append((comp.get(), custom.get(),
                        [c["metric"] for c in
                         plain.get_config()["metrics"]]))
    (tn, tv), (tcn, tcv), tcfg = res[1]
    (jn, jv), (jcn, jcv), jcfg = res[0]
    assert tn == jn and tcn == jcn and tcfg == jcfg
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tcv, jcv, rtol=RTOL, atol=ATOL)
    assert isinstance(tmx.metric.create("top_k_acc", top_k=2),
                      tmx.metric.TopKAccuracy)
    with pytest.raises(ValueError, match="Cannot find metric"):
        tmx.metric.create("no_such_metric")
    with pytest.raises(NotImplementedError):
        tmx.metric.create(lambda l, p: 0.0).get_config()


def test_loss_metric_excludes_non_finite_values():
    m = tmx.metric.Loss()
    with pytest.warns(RuntimeWarning, match="non-finite"):
        m.update(None, [np.array([1.0, np.nan, 3.0], np.float32)])
    assert m.num_nonfinite == 1
    assert m.get() == ("loss", 2.0)
    with pytest.raises(ValueError, match="does not match"):
        tmx.metric.check_label_shapes([1, 2], [1])
