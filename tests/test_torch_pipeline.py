"""The port's pipeline parallelism against the JAX package's, on the CPU.

The multi-rank cases run in one gloo gang of four rank processes
(``torch_rank_worker.py`` suite ``pipeline``, started once for the
module): ``pipeline_apply`` over pp=4, and ``PipelineTrainer`` over pp=2
with both schedules, three steps each, on a Dense tower
(``test_parallel.py:612``), a Conv + BatchNorm tower (``:661``, the
running statistics too) and ``bert_pipeline_parts`` /
``gpt_pipeline_parts`` at tiny widths with their prologue and epilogue
(``:712``, ``:1025``, ``:1211``); and ``shard_model(mode="pp")`` with
``ShardedTrainer`` on the scanned BERT trunk.  Each is held against the
JAX package on the virtual CPU devices: ``pipeline_apply`` on a pp=4 mesh
and the JAX ``ShardedTrainer`` on one device, unpipelined where the
schedule's loss is the whole batch's (GPipe) and with ``grad_accum=4``
where it is the microbatches' mean (1F1B, and wherever the two agree).
The 1F1B tables are the JAX package's, and hold ``:1084``'s properties.

Tolerances: rtol 2e-4 / atol 2e-5 on outputs and losses, 2e-3 / 2e-4 on
trained parameters and statistics.
"""

import numpy as np
import pytest

import jax

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.parallel import pipeline as jpipeline

import torch_rank_cases as cases
from mxnet_tpu_torch.parallel import pipeline as tpipeline
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The gang, started once for the module and left running while the
    tests compute their JAX references; ``gang.dir()`` waits for it."""
    g = cases.start_gang("pipeline", tmp_path_factory.mktemp("pipeline_gang"))
    yield g
    g.close()


def test_1f1b_schedule_properties():
    """test_parallel.py:1084 on the port's tables, which equal the JAX
    package's."""
    for S, M in [(2, 4), (4, 8), (4, 4), (3, 5)]:
        assert tpipeline._schedule_1f1b(S, M) == \
            jpipeline._schedule_1f1b(S, M)
        rows_f, rows_b, T, bub = tpipeline._schedule_1f1b(S, M)
        TF, TB = {}, {}
        for t, row in enumerate(rows_f):
            for s, m in enumerate(row):
                if m >= 0:
                    TF[(m, s)] = t
        for t, row in enumerate(rows_b):
            for s, m in enumerate(row):
                if m >= 0:
                    TB[(m, s)] = t
        assert len(TF) == S * M and len(TB) == S * M
        for m in range(M):
            for s in range(1, S):
                assert TF[(m, s)] > TF[(m, s - 1)]
            for s in range(S - 1):
                assert TB[(m, s)] > TB[(m, s + 1)]
            assert TB[(m, S - 1)] > TF[(m, S - 1)]
        for s in range(S):
            events = sorted([(TF[(m, s)], 1) for m in range(M)] +
                            [(TB[(m, s)], -1) for m in range(M)])
            cur = peak = 0
            for _, d in events:
                cur += d
                peak = max(peak, cur)
            assert peak <= S - s
        assert abs(bub - (1.0 - 2.0 * M / T)) < 1e-9
        assert tpipeline.gpipe_bubble_fraction(S, M) == \
            jpipeline.gpipe_bubble_fraction(S, M)


def _jax_apply():
    import jax.numpy as jnp

    mesh = jparallel.make_mesh(pp=4)
    stacked = jax.device_put(
        jparallel.stack_stage_params(
            [{k: jnp.asarray(v) for k, v in w.items()}
             for w in cases.PIPE_W]),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("pp")))
    return np.asarray(jparallel.pipeline_apply(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), stacked,
        jnp.asarray(cases.PIPE_X), mesh=mesh))


def test_pipeline_apply_matches_jax(gang, refs):
    """test_parallel.py:501 over pp=4: every rank holds the last stage's
    outputs."""
    want = refs["apply"]
    for r in range(4):
        np.testing.assert_allclose(
            cases.load(gang.dir(), "pipeline_apply_pp4", r)["out"], want, RTOL,
            ATOL)


def _jax_trained(net, loss, x, y, opt, grad_accum=1, trainable_only=False,
                 short=False):
    """Three steps of the JAX trainer on one device: the losses and
    [(name, trained value)], the names less the net's prefix with
    ``short`` (a net built without a prefix of its own is named by a
    counter that differs between processes)."""
    tr = jparallel.ShardedTrainer(net, loss, opt[0], dict(opt[1]),
                                  mesh=jparallel.make_mesh(dp=1),
                                  grad_accum=grad_accum)
    label = tuple(jmx.nd.array(a) for a in y) if isinstance(y, tuple) \
        else jmx.nd.array(y)
    losses = [float(np.asarray(tr.step(jmx.nd.array(x), label)._data,
                               dtype=np.float32))
              for _ in range(cases.STEPS)]
    tr.sync_params()
    cut = len(net.prefix) if short else 0
    return losses, [(n[cut:], p.data().asnumpy())
                    for n, p in net.collect_params().items()
                    if not trainable_only or p.grad_req != "null"]


def _hold(gang, case, ref, bubble=None):
    losses, params = ref
    for r in range(2):
        res = cases.load(gang.dir(), case, r)
        np.testing.assert_allclose(res["losses"], losses, RTOL, ATOL)
        got = sorted(k for k in res if k.startswith("p") and ":" in k)
        assert [k.split(":", 1)[1] for k in got] == [n for n, _ in params]
        for k, (n, want) in zip(got, params):
            np.testing.assert_allclose(res[k], want, GRAD_RTOL, GRAD_ATOL,
                                       err_msg=n)
        if bubble is not None:
            assert float(res["bubble"]) == pytest.approx(bubble)


@pytest.fixture(scope="module")
def refs():
    """Every JAX trajectory of the module, computed while the gang runs;
    cases that differ only on the port's side share one."""
    return {
        "mlp": _jax_trained(cases.tanh_mlp(jmx, 7), jmx.gluon.loss.L2Loss(),
                            cases.MLP8_X, cases.MLP8_Y, cases.ADAM01),
        "bn": _jax_trained(cases.bn_tower(jmx, 5), jmx.gluon.loss.L2Loss(),
                           cases.BN_X, cases.BN_Y, cases.SGD05,
                           grad_accum=4),
        **{f"bert{a}": _jax_trained(
            cases.pipeline_parts(jmx, "bert", 11), jbert.BERTMLMLoss(),
            cases.PP_IDS, cases.PP_LABELS, cases.SGD05, grad_accum=a)
           for a in (1, 4)},
        "gpt": _jax_trained(cases.pipeline_parts(jmx, "gpt", 13),
                            jgpt.GPTLMLoss(), cases.PP_IDS, cases.PP_IDS,
                            cases.SGD05, grad_accum=4),
        "pretrain": _jax_trained(cases.bert(jmx), jbert.BERTPretrainLoss(),
                                 cases.bert_batch()[0],
                                 cases.bert_batch()[1:], cases.BERT_OPT,
                                 trainable_only=True, short=True),
        "apply": _jax_apply(),
    }


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_trainer_matches_unpipelined(gang, refs, schedule):
    """test_parallel.py:612: the Dense tower's mean L2 loss is the same
    over the whole batch and over equal microbatches, so both schedules
    hold against ordinary full-batch training (Adam)."""
    ref = refs["mlp"]
    bubble = (tpipeline._schedule_1f1b(2, 4)[3] if schedule == "1f1b"
              else tpipeline.gpipe_bubble_fraction(2, 4))
    assert 0.0 < bubble < 1.0
    _hold(gang, f"mlp_pp2_{schedule}", ref, bubble)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_trainer_batchnorm_matches_microbatched(gang, refs, schedule):
    """test_parallel.py:661: BatchNorm stages, their statistics per
    microbatch, against grad_accum=4 training; parameters and running
    statistics."""
    ref = refs["bn"]
    assert any("running" in n for n, _ in ref[1])
    _hold(gang, f"bn_pp2_{schedule}", ref)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_bert_matches(gang, refs, schedule):
    """test_parallel.py:712 (GPipe against unpipelined training) and
    :1025 (1F1B against grad_accum=4: the MLM loss is normalised by each
    microbatch's own masked count): bert_pipeline_parts with the
    embedding as prologue and the MLM head as epilogue."""
    ref = refs["bert1" if schedule == "gpipe" else "bert4"]
    _hold(gang, f"bert_pp2_{schedule}", ref)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_gpt_matches_grad_accum(gang, refs, schedule):
    """test_parallel.py:1211: gpt_pipeline_parts under both schedules
    against grad_accum=4 (every label valid: the whole batch's mean is
    the microbatches')."""
    ref = refs["gpt"]
    _hold(gang, f"gpt_pp2_{schedule}", ref)


def test_shard_model_pp_trains(gang, refs):
    """shard_model(mode="pp") gives each of two pp ranks one layer of the
    scanned trunk's stacks; ShardedTrainer gathers them for the step and
    trains as one device does."""
    losses, params = refs["pretrain"]
    for r in range(2):
        res = cases.load(gang.dir(), "tp_stack_pp2", r)
        assert int(res["local_layers"]) == 1
        assert str(res["qkv_spec"]) == "('pp', None, None)"
        np.testing.assert_allclose(res["losses"], losses, RTOL, ATOL)
        port = {k.split("_", 1)[1]: v for k, v in res.items()
                if k.startswith("p:")}
        assert sorted(port) == sorted(n for n, _ in params)
        for n, want in params:
            np.testing.assert_allclose(port[n], want, GRAD_RTOL, GRAD_ATOL,
                                       err_msg=n)
