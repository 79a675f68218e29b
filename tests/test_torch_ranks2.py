"""The multi-rank paths of two ranks against the JAX package (or against
one rank where the reference cannot run them), on the CPU.

One gloo gang of two rank processes (``torch_rank_worker.py``, suite
``ranks2`` of ``torch_rank_cases``) runs every case while this process
computes the JAX references:

- ``DevicePrefetcher`` over a dp=2 rank mesh: each rank's rows of every
  batch bitwise equal to the JAX prefetcher's shard of it (a batch dp does
  not divide whole on both), and the producer's warm ``row_sparse_pull``
  equal to the JAX prefetcher's on the rank's rows;
- ``CachedDecoder(mesh=)`` and ``ServingEngine(mesh=)`` at tp=2 on
  gpt_tiny: against one rank and the JAX decoder and engine on a tp=2 CPU
  mesh (logits within rtol 2e-4 / atol 1e-5, tokens equal);
- a ``ShardedEmbedding`` table row-sharded over dp=2 by
  ``EmbeddingRules`` (and a vocab dp does not divide, replicated) through
  three ``ShardedTrainer`` steps against the JAX trainer on a dp=2 mesh;
- the compressed (2bit, fp16) row-sparse push across two workers bitwise
  equal to two JAX one-worker stores' quantised dense views, summed;
- ``Module.fit`` over ``dist_sync`` against one rank on the global batch;
- ``shard_activations`` and ``annotate_activations`` on a tp=2 rank mesh:
  as the JAX constraint, the output's value unchanged and its layout
  recorded, the no-op annotations recording none; a two-layer net with
  its hidden projection annotated, trained at tp=2 by ``ShardedTrainer``
  and run whole after it, against the JAX trainer.

Tolerances: 2e-4 / 2e-5 on values and losses, 2e-3 / 2e-4 on trained
weights (``tests/test_torch_dist.py``'s).
"""

import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo import gpt as jgpt

import torch_rank_cases as cases
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
W_RTOL, W_ATOL = 2e-3, 2e-4


def _jax_gpt():
    """The JAX gpt_tiny (scanned trunk, Xavier from seed 7) the ranks
    load through ``convert.load_state``."""
    jmx.random.seed(7)
    net = jgpt.gpt_tiny(scan_layers=True, max_length=32, num_layers=2)
    net.initialize(init=jmx.init.Xavier())
    net(jnd.array(np.zeros((1, 4), np.float32)))
    return net


@pytest.fixture(scope="module")
def jax_gpt():
    return _jax_gpt()


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_gpt):
    out = tmp_path_factory.mktemp("ranks2_gang")
    path = out / "gpt_state.npz"
    np.savez(path, **jserving.state_for_serving(jax_gpt))
    os.environ["MXTPU_TEST_GPT_STATE"] = str(path)
    try:
        g = cases.start_gang("ranks2", out)
    finally:
        os.environ.pop("MXTPU_TEST_GPT_STATE", None)
    yield g
    g.close()


def _tp_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))


def _shard(arr, r):
    """Device r's block of a JAX NDArray placed over a two-device mesh."""
    shards = sorted(arr._data.addressable_shards, key=lambda s: s.device.id)
    return np.asarray(shards[r].data)


def _rank_rows(a, r):
    return a[r * len(a) // 2:(r + 1) * len(a) // 2]


def test_prefetcher_places_each_ranks_rows_like_jax(gang):
    from mxnet_tpu.gluon.data import DevicePrefetcher

    placed = list(DevicePrefetcher(cases.PF_BATCHES, depth=2,
                                   mesh=jparallel.make_mesh(dp=2)))
    net = cases.sparse_tower(jmx)
    name = net[0].weight.name
    pulls = []
    for r in range(2):
        kv = jmx.kv.create("local")
        kv.init(name, jnd.array(cases.PF_TABLE))
        dest = jmx.nd.sparse.zeros("row_sparse", cases.PF_TABLE.shape)
        pf = DevicePrefetcher([_rank_rows(b, r) for b in cases.PF_IDS],
                              depth=0, sparse_tables=net, kvstore=kv,
                              warm_pull={name: dest})
        pulls.append([(dest.indices.asnumpy(), dest.data.asnumpy())
                      for _ in pf])
    for r in range(2):
        got = cases.load(gang.dir(), "prefetch_dp2", r)
        for k, (x, y) in enumerate(placed):
            for depth in (2, 0):
                np.testing.assert_array_equal(got[f"x{k}.d{depth}"],
                                              _shard(x, r))
                np.testing.assert_array_equal(got[f"y{k}.d{depth}"],
                                              _shard(y, r))
        # the 7-row batch dp does not divide: whole on both ranks
        assert got["x2.d2"].shape == (7, 3)
        for k, (idx, rows) in enumerate(pulls[r]):
            for depth in (0, 2):
                np.testing.assert_array_equal(
                    got[f"ids{k}.d{depth}"], _rank_rows(cases.PF_IDS[k], r))
            np.testing.assert_array_equal(got[f"pulled_idx{k}"], idx)
            np.testing.assert_array_equal(got[f"pulled{k}"], rows)
        for depth in (0, 2):
            np.testing.assert_array_equal(got[f"pulled_last_idx.d{depth}"],
                                          pulls[r][-1][0])
            np.testing.assert_array_equal(got[f"pulled_last.d{depth}"],
                                          pulls[r][-1][1])
        # threaded, every pull ran on the producer thread
        threads = list(got["pull_threads"])
        assert threads[:3] == ["MainThread"] * 3
        assert threads[3:] == ["mxtpu-device-prefetch"] * 3


def _equiv(ref_t, ref_lg, got_t, got_lg, T0):
    """First logits within rtol 2e-4 / atol 1e-5; tokens equal, or parting
    only where the logits agree to that tolerance (a rounding tie)."""
    np.testing.assert_allclose(got_lg[0], ref_lg[0], rtol=2e-4, atol=1e-5)
    if np.array_equal(ref_t, got_t):
        return
    j = int(np.argwhere((ref_t != got_t).any(axis=0))[0, 0]) - T0
    np.testing.assert_allclose(got_lg[j], ref_lg[j], rtol=2e-4, atol=1e-5,
                               err_msg=f"tokens diverged at step {j}")


def test_tp2_decode_and_serving_match_one_rank_and_jax(gang, jax_gpt):
    mesh = _tp_mesh()
    ref_t, ref_lg = jgpt.CachedDecoder(jax_gpt, mesh=mesh).decode(
        jnd.array(cases.DEC_IDS.astype(np.float32)), max_new_tokens=5,
        return_logits=True)
    engine = jserving.ServingEngine(jax_gpt, batch_buckets=(2,), mesh=mesh)
    ref_serve, _ = engine.serve_group(cases.SERVE_PROMPTS, 4)
    ranks = [cases.load(gang.dir(), "decode_tp2", r) for r in range(2)]
    for got in ranks:
        assert got["cache_heads.tp"] == 1 and got["cache_heads.one"] == 2
        _equiv(got["toks.one"], got["logits.one"], got["toks.tp"],
               got["logits.tp"], T0=6)
        _equiv(ref_t.asnumpy(), ref_lg, got["toks.tp"], got["logits.tp"],
               T0=6)
        for i, want in enumerate(ref_serve):
            np.testing.assert_array_equal(got[f"serve{i}.tp"], want)
            np.testing.assert_array_equal(got[f"serve{i}.one"], want)
        assert got["recordings.tp"] == 0
    # the all-reduced logits are the same bits on both ranks
    np.testing.assert_array_equal(ranks[0]["logits.tp"],
                                  ranks[1]["logits.tp"])


@pytest.mark.parametrize("case,vocab,local_rows", [
    ("embed_rows_dp2", 20, 10), ("embed_rows_uneven_dp2", 21, -1)])
def test_row_sharded_table_trains_like_jax(gang, case, vocab, local_rows):
    net = cases.sparse_tower(jmx, vocab=vocab)
    rs = np.random.RandomState(540)
    x = rs.randint(0, vocab, (8, 2)).astype(np.float32)
    y = (np.arange(8) % 5).astype(np.float32)
    tr = jparallel.ShardedTrainer(
        net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), cases.SGD[0],
        dict(cases.SGD[1]), mesh=jparallel.make_mesh(dp=2),
        rules=jparallel.EmbeddingRules())
    losses = [float(np.asarray(tr.step(x, y)._data))
              for _ in range(cases.STEPS)]
    tr.sync_params()
    params = net.collect_params()
    for r in range(2):
        got = cases.load(gang.dir(), case, r)
        assert int(got["local_rows"]) == local_rows
        # a row-sharded table leaves the module until sync_params
        assert int(got["module_rows"]) == (0 if local_rows > 0 else vocab)
        np.testing.assert_array_equal(
            got["synced"], got["p:" + net[0].weight.name])
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL,
                                   atol=ATOL)
        for name, p in params.items():
            np.testing.assert_allclose(got["p:" + name],
                                       p.data().asnumpy(), rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=name)


@pytest.mark.parametrize("gc_type", ["2bit", "fp16"])
def test_compressed_rowsparse_push_across_workers_like_jax_stores(
        gang, gc_type):
    shape = (12, 2)
    pulls, residuals = [], []
    for r in range(2):
        kv = jmx.kv.create("device")
        kv.set_gradient_compression({"type": gc_type, "threshold": 0.5})
        kv.init("emb", jnd.zeros(shape))
        pulled, res = [], []
        for vals, ids in cases.RS_ROUNDS[r]:
            dense = np.zeros(shape, np.float32)
            dense[ids] = np.asarray(vals, np.float32)
            kv.push("emb", jnd.array(dense))
            out = jnd.zeros(shape)
            kv.pull("emb", out=out)
            pulled.append(out.asnumpy())
            res.append(np.asarray(kv._compression._residual["emb"]))
        pulls.append(np.stack(pulled))
        residuals.append(np.stack(res))
    for r in range(2):
        got = cases.load(gang.dir(), f"compress_rowsparse_{gc_type}", r)
        np.testing.assert_array_equal(got["pulled"], pulls[0] + pulls[1])
        np.testing.assert_array_equal(got["residual"], residuals[r])


def test_module_fit_over_dist_sync_matches_one_rank(gang):
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        want = cases.module_fit(tmx, cases.MOD_X, cases.MOD_Y,
                                2 * cases.MOD_B, "local", 2 * cases.MOD_B)
    for r in range(2):
        got = cases.load(gang.dir(), "module_dist2", r)
        assert int(got["workers"]) == 2
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=name)


def test_shard_activations_on_a_rank_mesh_like_jax(gang):
    net = cases.mlp(jmx)
    x = jnd.array(cases.MLP_X[:4])
    plain, first = net(x).asnumpy(), net[0](x).asnumpy()
    net[0].shard_activations((None, "tp"), _tp_mesh())
    constrained, whole = net[0](x).asnumpy(), net(x).asnumpy()
    np.testing.assert_array_equal(constrained, first)
    # XLA lays the next product out over the constraint: the same value
    # to its rounding
    np.testing.assert_allclose(whole, plain, rtol=RTOL, atol=ATOL)
    want_spec = {"sharded": "(None, 'tp')", "no_axis": "(None, None)",
                 "too_long": "", "no_mesh": "", "annotated": "(None, 'tp')",
                 "tensor": "(None, 'tp')"}
    for r in range(2):
        got = cases.load(gang.dir(), "shard_activations_tp2", r)
        np.testing.assert_allclose(got["first"], first, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["plain"], plain, rtol=RTOL,
                                   atol=ATOL)
        # the layout changes, the value never does
        for tag, spec in want_spec.items():
            np.testing.assert_array_equal(got[tag], got["first"],
                                          err_msg=tag)
            assert str(got["spec." + tag]) == spec, tag
        np.testing.assert_array_equal(got["whole"], got["plain"])
        np.testing.assert_allclose(got["whole"], whole, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got["annotated_whole"], got["plain"])


def test_shard_activations_of_a_hidden_layer_under_tp_trainer_like_jax(
        gang):
    """The hidden projection annotated ``(None, 'tp')``: the tp=2 trainer's
    losses and weights, and the whole net's output after it, held against
    the JAX trainer on a tp=2 CPU mesh with the same annotation."""
    mesh = _tp_mesh()
    net = cases.mlp(jmx)
    net[0].shard_activations((None, "tp"), mesh)
    tr = jparallel.ShardedTrainer(
        net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), cases.SGD[0],
        dict(cases.SGD[1]), mesh=mesh,
        rules=jparallel.ShardingRules(rules=cases.MLP_TP_RULES))
    losses = [float(np.asarray(tr.step(cases.MLP_X, cases.MLP_Y)._data))
              for _ in range(cases.STEPS)]
    tr.sync_params()
    params = net.collect_params()
    # the trained weights, on one device, through the annotated net
    fresh = cases.mlp(jmx)
    for name, p in fresh.collect_params().items():
        p.set_data(params[name].data().asnumpy())
    fresh[0].shard_activations((None, "tp"), mesh)
    whole = fresh(jnd.array(cases.MLP_X[:4])).asnumpy()
    for r in range(2):
        got = cases.load(gang.dir(), "shard_activations_trainer_tp2", r)
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL,
                                   atol=ATOL)
        for name, p in params.items():
            np.testing.assert_allclose(got["p:" + name],
                                       p.data().asnumpy(), rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=name)
        np.testing.assert_allclose(got["whole"], whole, rtol=W_RTOL,
                                   atol=W_ATOL)
