"""The port's dist kvstore and gradient compression against the JAX
package's, on the CPU.

One gloo gang of two rank processes (``torch_rank_worker.py``, started
once for the module) runs every multi-rank case of ``torch_rank_cases``'s
``dist`` suite: the counterpart of ``tests/dist_sync_kvstore.py`` (pushes
summed, list keys, ``barrier``, ``gluon.Trainer(kvstore="dist_sync")``
keeping the weights bit-identical across the ranks, with the store's
update, the local update and 2-bit compression), the 2-bit and fp16 wires
with their residuals, and ``bucketed_pushpull`` at two bucket budgets.
Each case's arrays are held here against the JAX package's
``GradientCompression`` and Gluon ``Trainer`` on the same numpy
gradients and batches.  The one-process cases (the compression's codes,
residuals, ``decode_sum``, the row-sparse carry, ``notify_mesh_reshape``
and the backend rule) run in this process.

Tolerances: rtol 2e-4 / atol 2e-5 on values, 2e-3 / 2e-4 on trained
weights.
"""

import socket

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gradient_compression import \
    GradientCompression as JGradientCompression

import mxnet_tpu_torch as tmx
import torch_rank_cases as cases
from mxnet_tpu_torch import distributed, kvstore
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gradient_compression import GradientCompression
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_gang")
    cases.run_gang("dist", out)
    return out


def _both(gang, case):
    return [cases.load(gang, case, r) for r in range(2)]


def test_pushes_sum_list_keys_and_barrier(gang):
    for r, got in enumerate(_both(gang, "kv_invariants")):
        assert int(got["rank"]) == r and int(got["nw"]) == 2
        np.testing.assert_array_equal(got["w0"], np.full((8, 8), 3.0))
        np.testing.assert_array_equal(got["a"], np.full((4,), 1.0))
        np.testing.assert_array_equal(got["b"], np.full((2, 3), 2.0))
        assert list(got["kinds"]) == ["dist_device_sync", "dist_async"]


def _jax_dense():
    net = jgluon.nn.Dense(4, in_units=8, prefix="d_")
    net.initialize()
    return cases._fill(net, 42)


def _jax_kv_trainer(compressed=False):
    """The JAX Gluon Trainer on both ranks' batches at once: the store's
    sum of the two ranks' gradients is the gradient of the joined batch.
    With 2-bit compression each rank's gradient goes through the JAX
    ``GradientCompression`` and the decoded codes are summed, as the
    wire does."""
    net = _jax_dense()
    loss_fn = jgluon.loss.L2Loss()
    if not compressed:
        tr = jgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        x = jmx.nd.array(np.concatenate(cases.KV_X))
        y = jmx.nd.array(np.concatenate(cases.KV_Y))
        for _ in range(2):
            with jag.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        return net
    gcs = [JGradientCompression({"type": "2bit", "threshold": 0.01})
           for _ in range(2)]
    params = [net.weight, net.bias]
    for _ in range(2):
        per_rank = []
        for r in range(2):
            with jag.record():
                loss = loss_fn(net(jmx.nd.array(cases.KV_X[r])),
                               jmx.nd.array(cases.KV_Y[r]))
            loss.backward()
            per_rank.append([p.grad()._data for p in params])
        for i, p in enumerate(params):
            packed = np.stack([np.asarray(gcs[r].codes(i, per_rank[r][i]))
                               for r in range(2)])
            summed = np.asarray(JGradientCompression.decode_sum(
                packed, per_rank[0][i].size, 0.01, np.float32)).reshape(
                    p.shape)
            p.set_data(p.data().asnumpy() - 0.1 * summed / 8)
    return net


@pytest.mark.parametrize("case", ["kv_trainer", "kv_trainer_local_update"])
def test_dist_sync_trainer_matches_jax_and_ranks_agree(gang, case):
    r0, r1 = _both(gang, case)
    np.testing.assert_array_equal(r0["w"], r1["w"])
    np.testing.assert_array_equal(r0["b"], r1["b"])
    assert bool(r0["on_kv"]) == (case == "kv_trainer")
    want = _jax_kv_trainer()
    np.testing.assert_allclose(r0["w"], want.weight.data().asnumpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(r0["b"], want.bias.data().asnumpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_dist_sync_trainer_with_2bit_compression(gang):
    r0, r1 = _both(gang, "kv_trainer_compressed")
    np.testing.assert_array_equal(r0["w"], r1["w"])
    want = _jax_kv_trainer(compressed=True)
    np.testing.assert_allclose(r0["w"], want.weight.data().asnumpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(r0["b"], want.bias.data().asnumpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", ["2bit", "fp16"])
def test_compressed_wire_matches_jax(gang, kind):
    params = {"type": kind, "threshold": 0.5} if kind == "2bit" \
        else {"type": kind}
    gcs = [JGradientCompression(params) for _ in range(2)]
    got = _both(gang, f"compress_{kind}")
    for rnd in range(3):
        gs = [cases.grads(r)[rnd] for r in range(2)]
        if kind == "2bit":
            packed = np.stack([np.asarray(gcs[r].codes("g", gs[r]))
                               for r in range(2)])
            want = np.asarray(JGradientCompression.decode_sum(
                packed, 37, 0.5, np.float32))
        else:
            want = sum(np.asarray(gcs[r].quantize_fp16_wire("g", gs[r]),
                                  np.float32) for r in range(2))
        for r in range(2):
            np.testing.assert_allclose(got[r]["pulled"][rnd], want,
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got[r]["residual"][rnd],
                                       np.asarray(gcs[r]._residual["g"]),
                                       rtol=RTOL, atol=ATOL)


def test_bucketed_pushpull_equals_per_key(gang):
    got = _both(gang, "bucketed")
    for r in range(2):
        assert got[r]["tiny"].all() and got[r]["big"].all()
    want = sum(_bucket_values(r)[2] for r in range(2))
    np.testing.assert_allclose(got[0]["sum"], want, rtol=RTOL, atol=ATOL)


def test_collective_helpers_over_two_ranks(gang):
    got = _both(gang, "collectives")
    total = got[0]["x"] + got[1]["x"]
    batch = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["summed"], total)
        np.testing.assert_array_equal(g["shard"], batch[4 * r:4 * r + 4])
        np.testing.assert_array_equal(g["rep"], np.full(3, 3.0))
        # rank r's slot j came from rank j, which sent 10 j + r
        np.testing.assert_array_equal(
            g["a2a"], [[10.0 * j + r] * 2 for j in range(2)])
        assert float(g["bw"]) > 0


def _bucket_values(rank):
    rs = np.random.RandomState(400 + rank)
    return [rs.randn(*s).astype(dt) for s, dt in
            [((5, 3), np.float32), ((7,), np.float64),
             ((300,), np.float32), ((2, 2), np.float64),
             ((64, 5), np.float32)]]


# -- one process ---------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.5, 0.1])
def test_2bit_codes_residuals_and_decode_match_jax(threshold):
    rs = np.random.RandomState(7)
    tg = GradientCompression({"type": "2bit", "threshold": threshold})
    jg = JGradientCompression({"type": "2bit", "threshold": threshold})
    for _ in range(3):
        g = (rs.randn(3, 11) * 0.4).astype(np.float32)
        tc = tg.codes("k", torch.from_numpy(g))
        jc = np.asarray(jg.codes("k", g))
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_allclose(tg._residual["k"].numpy(),
                                   np.asarray(jg._residual["k"]),
                                   rtol=RTOL, atol=ATOL)
        rows = np.stack([jc, jc[::-1]])
        np.testing.assert_allclose(
            GradientCompression.decode_sum(torch.from_numpy(rows), 33,
                                           threshold, "float32").numpy(),
            np.asarray(JGradientCompression.decode_sum(rows, 33, threshold,
                                                       np.float32)),
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["2bit", "fp16"])
def test_quantize_and_rowsparse_carry_match_jax(kind):
    rs = np.random.RandomState(8)
    tg = GradientCompression({"type": kind, "threshold": 0.3})
    jg = JGradientCompression({"type": kind, "threshold": 0.3})
    for _ in range(2):
        g = (rs.randn(9) * 0.5).astype(np.float32)
        np.testing.assert_allclose(
            tg.quantize("d", torch.from_numpy(g)).numpy(),
            np.asarray(jg.quantize("d", g)), rtol=RTOL, atol=ATOL)
        ids = rs.randint(0, 20, 6)
        vals = (rs.randn(6, 2) * 0.4).astype(np.float32)
        tu, tq = tg.quantize_rowsparse("e", torch.from_numpy(ids),
                                       torch.from_numpy(vals))
        ju, jq = jg.quantize_rowsparse("e", ids, vals)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=RTOL,
                                   atol=ATOL)
        tr, jr = tg._residual.get("e"), jg._residual.get("e")
        assert (tr is None) == (jr is None)
        if tr is not None:
            np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
            np.testing.assert_allclose(tr[1].numpy(), np.asarray(jr[1]),
                                       rtol=RTOL, atol=ATOL)


def test_compression_refusals_match_jax():
    for bad in ({"type": "1bit"}, {"type": "2bit", "threshold": 0},
                {"type": "2bit", "bogus": 1}):
        with pytest.raises(MXNetError):
            GradientCompression(bad)
        with pytest.raises(jmx.base.MXNetError):
            JGradientCompression(bad)
    with cpu():
        with pytest.raises(MXNetError, match="device"):
            tmx.kv.create("local").set_gradient_compression({"type": "2bit"})
    # a store of one worker: the dist type keeps its store, compression on
    kv = tmx.kv.create("dist_sync")
    assert kv.num_workers == 1 and kv.rank == 0
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    with cpu():
        kv.init(3, tmx.nd.zeros((4,)))
        kv.push(3, tmx.nd.array([0.7, -0.6, 0.2, 0.0]))
        out = tmx.nd.zeros((4,))
        kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), [0.5, -0.5, 0.0, 0.0])
    assert tmx.gluon.trainer.kvstore_requires_store(kv)


def test_notify_mesh_reshape_changes_the_fingerprint():
    epoch = kvstore._MESH_EPOCH
    before = kvstore.device_fingerprint()
    try:
        kvstore.notify_mesh_reshape(epoch + 7)
        after = kvstore.device_fingerprint()
        assert after != before and after[0] == epoch + 7
    finally:
        kvstore.notify_mesh_reshape(epoch)
    assert kvstore.device_fingerprint() == before


def _ranks(host, cards, n, on_host=False):
    return [(host, cards, on_host)] * n


def test_backend_rule_names_its_choice(monkeypatch):
    """Each rank's entry from its stubbed cards and scope, and the choice
    with its reason on one host."""
    host = socket.gethostname()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.local_member() == (host, 1, False)
    assert distributed.backend_rule([distributed.local_member()])[0] == \
        "nccl"
    backend, reason = distributed.backend_rule(
        [distributed.local_member()] * 2)
    assert backend == "gloo" and "share" in reason
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.backend_rule([distributed.local_member()] * 4) == (
        "nccl", "4 ranks on 1 host(s), one card each")
    with cpu():
        assert distributed.local_member() == (host, 4, True)
        assert distributed.backend_rule(
            [distributed.local_member()] * 4) == (
                "gloo", "the ranks run on the host (cpu scope)")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.local_member() == (host, 0, False)
    assert distributed.backend_rule([distributed.local_member()] * 2) == (
        "gloo", f"no CUDA card is visible on {host}: the ranks run on the "
        "host")


def test_backend_rule_over_hosts():
    """A world over several hosts counts the ranks of each host against
    that host's cards, and every rank reads the same list."""
    # 2 hosts of 8 cards, a rank a card: 16 ranks, 8 cards a host
    assert distributed.backend_rule(_ranks("a", 8, 8) + _ranks("b", 8, 8)) \
        == ("nccl", "16 ranks on 2 host(s), one card each")
    assert distributed.backend_rule(_ranks("a", 8, 2) + _ranks("b", 8, 8)) \
        [0] == "nccl"
    # one host with fewer cards than ranks turns the whole world to gloo
    backend, reason = distributed.backend_rule(
        _ranks("a", 8, 8) + _ranks("b", 4, 8))
    assert backend == "gloo" and "8 ranks share 4 card(s) on b" in reason
    assert distributed.backend_rule(_ranks("a", 8, 8) + _ranks("b", 0, 1)) \
        == ("gloo", "no CUDA card is visible on b: the ranks run on the "
            "host")
    # one rank in a cpu scope puts every rank on gloo
    assert distributed.backend_rule(
        _ranks("a", 8, 7) + _ranks("a", 8, 1, on_host=True))[0] == "gloo"
    # the order of the ranks does not change the choice
    mixed = _ranks("a", 8, 8) + _ranks("b", 4, 8)
    assert distributed.backend_rule(mixed[::-1]) == \
        distributed.backend_rule(mixed)