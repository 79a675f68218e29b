"""The port's sharding rules, rank meshes and ``ShardedTrainer`` at dp,
tp and fsdp against the JAX package's, on the CPU.

The rule classes run in this process, every case of
``tests/test_parallel.py:93-221`` on both packages.  The trainer cases
run in one gloo gang of four rank processes (``torch_rank_worker.py``,
started once for the module; a case on a two-rank mesh runs on ranks 0
and 1): ``ShardedTrainer`` at dp=2 on the MLP of ``test_parallel.py:436``
(and with ``grad_accum=2``), at dp=2 on a tiny ResNet with BatchNorm (the
global statistics), and at tp=2, fsdp=2 and dp=2 x tp=2 on
``bert_tiny(scan_layers=True, dropout=0.0)`` with
``TRANSFORMER_TP_RULES``; the packed-qkv head layout, the vocab-parallel
embedding, the dropout streams, the state round trip over shards and
``reshape_mesh`` from two ranks to one.  Each trainer case is held
against the JAX ``ShardedTrainer`` on a mesh of the same shape over the
virtual CPU devices: the losses of three steps, the trained parameters
and the optimizer states.

Tolerances: rtol 2e-4 / atol 2e-5 on losses and statistics, 2e-3 / 2e-4
on parameters and optimizer states.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import bert as jbert

import torch_rank_cases as cases
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_gang")
    cases.run_gang("sharding", out)
    return out


# -- the rules, both packages --------------------------------------------------

PKGS = {"jax": jparallel, "port": tparallel}


@pytest.fixture(params=["jax", "port"])
def P(request):
    return PKGS[request.param]


def test_sharding_rules_first_match_wins(P):
    rules = P.ShardingRules(rules=[(r"weight$", ("tp", None)),
                                   (r"special_weight$", (None, "tp"))])
    assert tuple(rules.spec_for("special_weight")) == ("tp", None)
    rules2 = P.ShardingRules(rules=[(r"special_weight$", (None, "tp")),
                                    (r"weight$", ("tp", None))])
    assert tuple(rules2.spec_for("special_weight")) == (None, "tp")


def test_sharding_rules_spec_for_shape_none_and_default(P):
    rules = P.ShardingRules(rules=[(r"w$", ("tp",))], default=("dp",))
    assert tuple(rules.spec_for("layer_w", shape=None)) == ("tp",)
    assert tuple(rules.spec_for("unmatched_bias")) == ("dp",)
    assert tuple(P.ShardingRules().spec_for("anything")) == ()


def test_combined_rules_override_semantics(P):
    a = P.ShardingRules(rules=[(r"weight$", ("tp", None))])
    b = P.ShardingRules(rules=[(r"weight$", (None, "tp")),
                               (r"bias$", ("tp",))])
    combo = P.combined_rules(a, b)
    assert tuple(combo.spec_for("x_weight")) == ("tp", None)
    assert tuple(combo.spec_for("x_bias")) == ("tp",)
    combo.add(r"bias$", (None,))
    assert tuple(combo.spec_for("x_bias")) == ("tp",)
    combo2 = P.combined_rules(a).add(r"gamma$", ("dp",))
    assert tuple(combo2.spec_for("bn_gamma")) == ("dp",)


def test_combined_rules_fsdp_shape_heuristic_ordering(P):
    tp = P.ShardingRules(rules=[(r"qkv_weight$", ("tp", None))])
    combo = P.combined_rules(tp, P.FSDPRules(axis_size=4, min_size=16))
    assert tuple(combo.spec_for("l0_qkv_weight", (12, 8))) == ("tp", None)
    assert tuple(combo.spec_for("l0_other_weight", (8, 4))) == ("dp", None)


def test_fsdp_rules_shape_heuristic(P, monkeypatch):
    rules = P.FSDPRules(axis_size=4, min_size=16)
    assert tuple(rules.spec_for("w", (8, 4))) == ("dp", None)
    assert tuple(rules.spec_for("w", (6, 8))) == (None, "dp")
    assert tuple(rules.spec_for("b", (3,))) == ()
    assert tuple(rules.spec_for("w", (6, 7))) == ()
    assert tuple(rules.spec_for("w", None)) == ()
    assert tuple(rules.spec_for("w", (4, 4, 4))) == ("dp", None, None)
    monkeypatch.setenv("MXTPU_FSDP_MIN_SIZE", "64")
    assert P.FSDPRules(axis_size=4).min_size == 64
    assert tuple(P.FSDPRules(axis_size=4).spec_for("w", (8, 4))) == ()


def test_combined_rules_three_way_tp_pp_dp_earlier_set_wins(P):
    tp = P.ShardingRules(rules=[(r"qkv_stack_weight$", (None, "tp", None))])
    dp = P.ShardingRules(rules=[(r"_stack_weight$", (None, "dp", None)),
                                (r"_stack_bias$", (None, "dp"))])
    combo = P.combined_rules(P.PPRules(), tp, dp)
    assert tuple(combo.spec_for("l_qkv_stack_weight", (4, 24, 8))) \
        == ("pp", "tp", None)
    assert tuple(combo.spec_for("l_ffn9_stack_weight", (4, 64, 8))) \
        == ("pp", "dp", None)
    assert tuple(combo.spec_for("l_qkv_stack_bias", (4, 24))) == ("pp", "dp")
    combo2 = P.combined_rules(P.PPRules(), dp, tp)
    assert tuple(combo2.spec_for("l_qkv_stack_weight", (4, 24, 8))) \
        == ("pp", "dp", None)


def test_combined_rules_conflicting_dim_assignment_raises(P):
    dp0 = P.ShardingRules(rules=[(r"_stack_weight$", ("dp", None, None))])
    combo = P.combined_rules(P.PPRules(), dp0)
    with pytest.raises(ValueError) as ei:
        combo.spec_for("l_qkv_stack_weight", (4, 24, 8))
    msg = str(ei.value)
    assert "l_qkv_stack_weight" in msg and "dim 0" in msg
    assert "'pp'" in msg and "'dp'" in msg
    pp0 = P.ShardingRules(rules=[(r"_stack_weight$", ("pp", None, None))])
    ok = P.combined_rules(P.PPRules(), pp0)
    assert tuple(ok.spec_for("l_qkv_stack_weight", (4, 24, 8))) \
        == ("pp", None, None)


def test_pp_rules_divisibility_and_fsdp_reroute(P):
    rules = P.pp_rules(axis_size=2)
    assert tuple(rules.spec_for("l_qkv_stack_weight", (4, 8, 8))) == ("pp",)
    assert tuple(rules.spec_for("l_qkv_stack_weight", (3, 8, 8))) == ()
    combo = P.combined_rules(P.pp_rules(axis_size=2),
                             P.FSDPRules(axis_size=4, min_size=16))
    assert tuple(combo.spec_for("l_ffn_stack_weight", (4, 8, 6))) \
        == ("pp", "dp", None)
    assert tuple(combo.spec_for("l_dense_weight", (8, 4))) == ("dp", None)


def test_transformer_rules_and_bulk_resolution_agree():
    names = {"enc_qkv_stack_weight": (2, 192, 64),
             "enc_qkv_stack_bias": (2, 192),
             "enc_proj_stack_weight": (2, 64, 64),
             "enc_ffn1_stack_weight": (2, 128, 64),
             "enc_ffn2_stack_weight": (2, 64, 128),
             "word_embed_weight": (1024, 64), "pooler_weight": (64, 64),
             "expert_ffn1_weight": (4, 8, 8), "l_embed_table": (30, 4)}
    for rules in ("TRANSFORMER_TP_RULES", "MOE_EP_RULES"):
        got = tparallel.match_partition_rules(
            getattr(tparallel, rules), names)
        want = jparallel.match_partition_rules(
            getattr(jparallel, rules), names)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    emb = tparallel.combined_rules(tparallel.embedding_rules(),
                                   tparallel.TRANSFORMER_TP_RULES)
    jemb = jparallel.combined_rules(jparallel.embedding_rules(),
                                    jparallel.TRANSFORMER_TP_RULES)
    for n, s in names.items():
        assert tuple(emb.spec_for(n, s)) == tuple(jemb.spec_for(n, s))


def test_row_sharded_tables_are_the_embedding_rules_claims():
    """``ShardedTrainer`` row-shards the tables the rules' ``EmbeddingRules``
    claim, by their own pattern, alone or inside ``combined_rules``."""
    mine = tparallel.embedding_rules(pattern=r"_user_rows$")
    assert mine.row_sharded("rec_user_rows")
    assert not mine.row_sharded("rec_embed_table")
    both = tparallel.combined_rules(tparallel.TRANSFORMER_TP_RULES, mine)
    assert both.row_sharded("rec_user_rows")
    assert not both.row_sharded("word_embed_weight")
    assert tparallel.embedding_rules().row_sharded("l_embed_table")
    for rules in (tparallel.TRANSFORMER_TP_RULES,
                  tparallel.fsdp_rules(axis_size=2)):
        assert not rules.row_sharded("l_embed_table")


def test_make_mesh_forms_and_errors():
    with cpu():
        mesh = tparallel.make_mesh(axes={"dp": 1})
        assert mesh.shape == {"dp": 1} and not mesh.is_rank_mesh
        with pytest.raises(ValueError, match="dp=2 \\* tp=2 = 4"):
            tparallel.make_mesh(dp=2, tp=2)
        with pytest.raises(ValueError, match="unknown axis"):
            tparallel.make_mesh(axes={"xp": 2})
        with pytest.raises(ValueError, match="not both"):
            tparallel.make_mesh(dp=2, axes={"tp": 2})
        devs = ["cpu"] * 4
        m = tparallel.make_mesh(dp=2, tp=2, devices=devs)
        assert m.axis_names == ("dp", "tp") and m.size == 4
        tparallel.set_default_mesh(m)
        assert tparallel.default_mesh() is m
        tparallel.set_default_mesh(None)
        assert [repr(p) for p in tparallel.sharded(m, None, "tp")] == \
            ["Replicate()", "Shard(dim=1)"]
        assert all(repr(p) == "Replicate()"
                   for p in tparallel.replicated(m))


def test_qkv_local_shard_holds_the_ranks_heads():
    """The packed qkv's shard on tp rank r is the rows of r's heads of q,
    k and v, and ``full_from_shards``'s inverse restores the layout."""
    from mxnet_tpu_torch.parallel import sharding

    class Stub:
        shape = {"tp": 2}

        def __init__(self, r):
            self.r = r

        def coord(self, axis):
            return self.r

    full = np.arange(2 * 24 * 3, dtype=np.float32).reshape(2, 24, 3)
    import torch

    spec = (None, "tp", None)
    parts = [sharding.local_shard("enc_qkv_stack_weight",
                                  torch.from_numpy(full), spec, Stub(r))
             .numpy() for r in range(2)]
    for r, part in enumerate(parts):
        want = np.concatenate([full[:, 8 * j + 4 * r:8 * j + 4 * r + 4]
                               for j in range(3)], axis=1)
        np.testing.assert_array_equal(part, want)
    plain = sharding.local_shard("enc_proj_stack_weight",
                                 torch.from_numpy(full), spec, Stub(1))
    np.testing.assert_array_equal(plain.numpy(), full[:, 12:])


# -- the gang ------------------------------------------------------------------

def _ranks(gang, case, n):
    return [cases.load(gang, case, r) for r in range(n)]


def _jax_train(net, loss, batch, label, opt, mesh, steps=cases.STEPS, **kw):
    tr = jparallel.ShardedTrainer(net, loss, opt[0], dict(opt[1]),
                                  mesh=mesh, **kw)
    losses = [float(np.asarray(tr.step(batch, label)._data))
              for _ in range(steps)]
    return tr, losses


def _jax_mesh(axes):
    """The JAX mesh of ``axes``, keeping a dp axis of size 1 (the JAX
    trainer lays the batch over its batch axis, which ``make_mesh`` drops
    when its size is 1)."""
    if "dp" in axes:
        return jparallel.make_mesh(**axes)
    import jax
    from jax.sharding import Mesh

    n = axes["tp"]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("dp", "tp"))


def _compare(got, tr, losses, aux=True):
    """The rank's arrays against the JAX trainer's losses, parameters,
    optimizer states and aux values."""
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    tr.sync_params()
    params = tr.block.collect_params()
    prefix = tr.block.prefix
    for (name, p), st in zip(tr._trainable, tr._opt_state):
        short = name[len(prefix):]
        tkey = "p:" + _port_name(got, short)
        np.testing.assert_allclose(got[tkey], p.data().asnumpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=short)
        for j, s in enumerate(st):
            np.testing.assert_allclose(
                got[f"s{j}:" + tkey[2:]], np.asarray(s), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"state {j} of {short}")
    if aux:
        for name, p in params.items():
            if p.grad_req == "null":
                short = name[len(prefix):]
                np.testing.assert_allclose(
                    got["a:" + _port_name(got, short, "a:")],
                    p.data().asnumpy(), rtol=RTOL, atol=ATOL,
                    err_msg=short)


def _port_name(got, short, tag="p:"):
    """The port's full name of the parameter whose name less its
    top-level prefix is ``short``."""
    hits = [k[len(tag):] for k in got if k.startswith(tag)
            and k[len(tag):].split("_", 1)[-1] == short]
    hits = hits or [k[len(tag):] for k in got if k.startswith(tag)
                    and k.endswith(short)]
    assert len(hits) == 1, (short, hits)
    return hits[0]


@pytest.mark.parametrize("case,accum", [("mlp_dp2", 1),
                                        ("mlp_accum_dp2", 2)])
def test_mlp_dp2_matches_jax(gang, case, accum):
    r0, r1 = _ranks(gang, case, 2)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    tr, losses = _jax_train(
        cases.mlp(jmx), jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        cases.MLP_X, cases.MLP_Y, ("sgd", {"learning_rate": 0.1}),
        jparallel.make_mesh(dp=2), grad_accum=accum)
    _compare(r0, tr, losses)


def test_data_parallel_trainer_over_four_ranks(gang):
    got = _ranks(gang, "data_parallel_dp4", 4)
    assert int(got[0]["dp"]) == 4
    for g in got[1:]:
        for k in got[0]:
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
    tr, losses = _jax_train(
        cases.mlp(jmx), jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        cases.MLP_X, cases.MLP_Y, ("sgd", {"learning_rate": 0.1}),
        jparallel.make_mesh(dp=4))
    _compare(got[0], tr, losses)


def test_batchnorm_takes_global_statistics_at_dp2(gang):
    """BatchNorm at dp=2 reduces over the global batch, forward and
    backward, as the JAX package's mean over a dp-sharded array does: the
    running statistics, losses and parameters match the JAX trainer."""
    r0, r1 = _ranks(gang, "resnet_bn_dp2", 2)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    tr, losses = _jax_train(
        cases.tiny_resnet(jmx), jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        cases.IMG_X, cases.IMG_Y, cases.SGD, jparallel.make_mesh(dp=2))
    _compare(r0, tr, losses)
    # one rank's half batch alone gives other statistics
    x = cases.IMG_X
    local = x[:4].transpose(1, 0, 2, 3).reshape(3, -1).mean(1)
    whole = x.transpose(1, 0, 2, 3).reshape(3, -1).mean(1)
    assert np.abs(local - whole).max() > 1e-2


_BERT = {"bert_tp2": ({"tp": 2}, {"rules": "tp"}),
         "bert_fsdp2": ({"dp": 2}, {"mode": "fsdp"}),
         "bert_dp2tp2": ({"dp": 2, "tp": 2}, {"rules": "tp"})}


@pytest.mark.parametrize("case", list(_BERT))
def test_bert_sharded_matches_jax(gang, case):
    """bert_tiny at tp=2, fsdp=2 and dp=2 x tp=2 against the JAX trainer.
    Under tp this holds the places a port goes wrong: each rank's heads of
    the packed qkv, the row-parallel proj and ffn2 biases added once after
    the sum (twice would move every loss), the vocab-parallel embedding,
    and the tied decoder's logits and loss over the full vocabulary."""
    axes, kw = _BERT[case]
    n = int(np.prod(list(axes.values())))
    got = _ranks(gang, case, n)
    for other in got[1:]:
        np.testing.assert_array_equal(other["losses"], got[0]["losses"])
    if "rules" in kw:
        kw = {"rules": jparallel.TRANSFORMER_TP_RULES}
    ids, mlm, nsp = cases.bert_batch()
    tr, losses = _jax_train(
        cases.bert(jmx), jbert.BERTPretrainLoss(), jmx.nd.array(ids),
        (jmx.nd.array(mlm), jmx.nd.array(nsp)), cases.BERT_OPT,
        _jax_mesh(axes), **kw)
    _compare(got[0], tr, losses, aux=False)


def test_tp_ranks_share_dropout_and_dp_ranks_do_not(gang):
    """tp ranks draw the same stream (their dropped activations are
    replicated: every rank's dp-mean loss agrees, and training moves on),
    dp ranks distinct ones."""
    got = _ranks(gang, "bert_dropout_dp2tp2", 4)
    for g in got[1:]:
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])
        np.testing.assert_array_equal(g["gamma"], got[0]["gamma"])
    assert np.isfinite(got[0]["losses"]).all()
    draws = _ranks(gang, "dropout_streams", 4)
    by = {(int(d["dp"]), int(d["tp"])): d["draws"] for d in draws}
    np.testing.assert_array_equal(by[0, 0], by[0, 1])
    np.testing.assert_array_equal(by[1, 0], by[1, 1])
    assert not np.array_equal(by[0, 0], by[1, 0])
    assert not np.array_equal(by[0, 0][0], by[0, 0][1])  # step to step


def test_shard_model_places_the_packed_qkv_by_heads(gang):
    for r, got in enumerate(_ranks(gang, "qkv_layout", 2)):
        full, bias = got["full"], got["bias"]
        L, three_u, u = full.shape
        h = three_u // 3 // 2
        want = np.concatenate([full[:, j * u + r * h:j * u + (r + 1) * h]
                               for j in range(3)], axis=1)
        np.testing.assert_array_equal(got["local"], want)
        np.testing.assert_array_equal(
            got["local_bias"],
            np.concatenate([bias[:, j * u + r * h:j * u + (r + 1) * h]
                            for j in range(3)], axis=1))
        assert list(got["placements"]) == ["Shard(dim=1)"]
        np.testing.assert_array_equal(got["back"], full)
        assert "ShardedTrainer" in str(got["refused"])


def test_vocab_parallel_embedding(gang):
    for got in _ranks(gang, "vocab_embed", 2):
        table, ids, dy, r = got["table"], got["ids"], got["dy"], \
            int(got["tp"])
        np.testing.assert_array_equal(got["out"], table[ids])
        dense = np.zeros_like(table)
        np.add.at(dense, ids.reshape(-1), dy.reshape(-1, 3))
        np.testing.assert_allclose(got["grad"], dense[r * 5:(r + 1) * 5],
                                   rtol=RTOL, atol=ATOL)


def test_state_round_trip_and_reshape_to_one_rank(gang):
    r0, r1 = _ranks(gang, "state_reshape", 2)
    assert bool(r0["roundtrip_equal"]) and bool(r1["roundtrip_equal"])
    assert r0["sharded"].any() and not r0["sharded"].all()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    tr = jparallel.ShardedTrainer(
        cases.mlp(jmx), jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, mesh=jparallel.make_mesh(dp=2),
        rules=jparallel.FSDPRules(axis_size=2, min_size=16))
    losses = [float(np.asarray(tr.step(cases.MLP_X, cases.MLP_Y)._data))
              for _ in range(2)]
    tr.reshape_mesh(jparallel.make_mesh(dp=1))
    losses.append(float(np.asarray(tr.step(cases.MLP_X, cases.MLP_Y)._data)))
    _compare(r0, tr, losses)
