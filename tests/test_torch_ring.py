"""The port's sequence parallelism against the JAX package's, on the CPU.

The multi-rank cases run in one gloo gang of four rank processes
(``torch_rank_worker.py`` suite ``ring``, started once for the module):
the collectives' probe with its point-to-point entries on host tensors,
``ring_attention`` (causal and not) and ``ulysses_attention`` over sp=4 on
(2, 8, 64, 16) inputs, outputs and gradients of each rank's block of
positions; ``bert_tiny(attention_impl="ring")``'s trunk over sp=4 (the
position embeddings at each rank's offset); and ``ShardedTrainer`` at
dp=2 x sp=2 on that trunk (ring), at sp=2 on ``gpt_tiny`` (ring, the LM
loss's shift across the ranks' blocks) and at dp=2 x sp=2 on ``gpt_tiny``
(Ulysses).  Each is held against the JAX package: its dense attention and
gradients (which its own ``ring_attention`` equals, ``test_parallel.py``),
the dense models' outputs, and the JAX ``ShardedTrainer``'s three steps
(the sequence axis leaves the global batch's mean loss as it is).

Tolerances: rtol 2e-4 / atol 2e-5 on outputs and losses, 2e-3 / 2e-4 on
gradients and trained parameters.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.ops.attention import scaled_dot_product_attention as jsdpa

import torch_rank_cases as cases
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The gang, started once for the module and left running while the
    tests compute their JAX references; ``gang.dir()`` waits for it."""
    g = cases.start_gang("ring", tmp_path_factory.mktemp("ring_gang"))
    yield g
    g.close()


def _joined(gang, case, key, ranks, dim=2):
    return np.concatenate([cases.load(gang.dir(), case, r)[key]
                           for r in ranks], axis=dim)


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed while the gang runs."""
    net = cases.bert_sp(jmx)
    net.hybridize()
    return {
        "dense": _dense_refs(),
        "bert_forward": net(jmx.nd.array(cases.SP_IDS[:2, :32])).asnumpy(),
        "bert": _jax_trained(cases.bert_sp(jmx), jmx.gluon.loss.L2Loss(),
                             cases.SP_IDS, cases.SP_TGT, cases.BERT_OPT),
        "gpt": _jax_trained(cases.gpt_sp(jmx), jgpt.GPTLMLoss(),
                            cases.GPT_IDS, cases.GPT_IDS, cases.BERT_OPT),
    }


def _dense_refs():
    """The JAX package's dense attention and its gradients of sum(out *
    cot), causal and not."""
    q, k, v = (jnp.asarray(a) for a in cases.QKV)
    cot = jnp.asarray(cases.COT)
    out = {}
    for causal in (False, True):
        def f(q, k, v, causal=causal):
            o = jsdpa(q, k, v, causal=causal)
            return jnp.sum(o * cot), o

        (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
        out[causal] = {"out": np.asarray(o), "dq": np.asarray(g[0]),
                       "dk": np.asarray(g[1]), "dv": np.asarray(g[2])}
    return out


@pytest.mark.parametrize("name,causal", [("ring", False),
                                         ("ring_causal", True),
                                         ("ulysses_causal", True)])
def test_sequence_parallel_attention_matches_dense(gang, refs, name, causal):
    """test_parallel.py:229-260, :309, :1163: ring and Ulysses over sp=4
    equal dense attention, outputs and gradients."""
    want = refs["dense"][causal]
    for key in ("out", "dq", "dk", "dv"):
        got = _joined(gang, "ring_sp4", f"{name}:{key}", range(4))
        tol = (RTOL, ATOL) if key == "out" else (GRAD_RTOL, GRAD_ATOL)
        np.testing.assert_allclose(got, want[key], *tol,
                                   err_msg=f"{name} {key}")


def test_probe_point_to_point_on_host(gang):
    """The probe's point-to-point entry (``ppermute``, one
    ``all_to_all_single``) passes on host tensors under gloo, beside the
    collectives it is built from (the card's answer for CUDA tensors is
    in PERF.md, PR 18)."""
    for r in range(4):
        res = cases.load(gang.dir(), "probe_host", r)
        got = dict(zip(res["names"].tolist(), res["results"].tolist()))
        for name in ("ppermute", "all_to_all_single", "all_reduce"):
            assert got[name] == "ok", (name, got[name])


def test_ring_causal_skips_blocks(gang):
    """The block-causal skip: rank r runs r + 1 of its 4 blocks (the
    JAX package's ``lax.switch`` branch 2 launches nothing either)."""
    for r in range(4):
        res = cases.load(gang.dir(), "ring_sp4", r)
        assert int(res["causal_blocks"]) == int(res["sp"]) + 1


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_unscoped_attention_takes_the_whole_sequence(gang, refs, name):
    """Outside a sharded step, with an sp mesh as the process default,
    ring and Ulysses attention on the whole sequence equal dense causal
    attention on every rank (the default mesh does not split it)."""
    want = refs["dense"][True]["out"]
    for r in range(4):
        got = cases.load(gang.dir(), "ring_sp4", r)[f"unscoped_{name}"]
        np.testing.assert_allclose(got, want, RTOL, ATOL, err_msg=str(r))


def test_bert_ring_attention_model(gang, refs):
    """test_parallel.py:547: bert_tiny(attention_impl="ring") over sp=4
    equals the dense model on the whole sequence."""
    want = refs["bert_forward"]
    got = _joined(gang, "bert_ring_forward_sp4", "out", range(4),
                  dim=1)
    assert got.shape == (2, 32, 64)
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def _jax_trained(net, loss, x, y, opt, steps=cases.STEPS):
    tr = jparallel.ShardedTrainer(net, loss, opt[0], dict(opt[1]),
                                  mesh=jparallel.make_mesh(dp=1))
    losses = [float(np.asarray(tr.step(jmx.nd.array(x), jmx.nd.array(y))
                               ._data, dtype=np.float32))
              for _ in range(steps)]
    tr.sync_params()
    return losses, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}


def _hold(got, losses, params, ranks):
    for r in ranks:
        res = got(r)
        np.testing.assert_allclose(res["losses"], losses, RTOL, ATOL)
        for n, want in params.items():
            np.testing.assert_allclose(res["p:" + n], want, GRAD_RTOL,
                                       GRAD_ATOL, err_msg=n)


def test_bert_ring_sharded_training_dp2sp2(gang, refs):
    """test_parallel.py:1184: ShardedTrainer over dp=2 x sp=2 on the ring
    trunk, three SGD steps, against the JAX trainer on the whole
    sequence."""
    losses, params = refs["bert"]
    assert losses[-1] < losses[0]
    _hold(lambda r: cases.load(gang.dir(), "bert_ring_dp2sp2", r), losses,
          params, range(4))


@pytest.mark.parametrize("case,ranks", [("gpt_ring_sp2", range(2)),
                                        ("gpt_ulysses_dp2sp2", range(4))])
def test_gpt_sequence_parallel_training(gang, refs, case, ranks):
    """gpt_tiny through ShardedTrainer with the sequence split: the LM
    loss's shift crosses the ranks' blocks, and the token mean is the
    global batch's."""
    _hold(lambda r: cases.load(gang.dir(), case, r), *refs["gpt"], ranks)


@pytest.mark.parametrize("axes,extra", [
    (("pp", "dp", "tp"), []),
    (("dp", "sp"), []),
    (("dp", "sp", "ep", "tp"), [("dp", "sp"), ("dp", "ep"), ("sp", "ep"),
                                ("sp", "tp"), ("ep", "tp"),
                                ("dp", "sp", "ep"), ("sp", "ep", "tp")]),
])
def test_mesh_groups_beyond_the_axes(axes, extra):
    """A rank mesh makes a group for each axis and, beyond them, only for
    the sets of axes that split the global batch's tokens (sp and/or ep
    with at most one other axis): a mesh without sp or ep makes none."""
    from mxnet_tpu_torch.parallel import mesh as pmesh

    assert pmesh._group_axes(axes) == [(a,) for a in axes] + extra
