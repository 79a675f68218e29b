"""The port's MoE op, its Gluon layer and expert parallelism against the
JAX package's, on the CPU.

In this process, on the same seeded numpy inputs through both packages'
``moe_ffn``: top-1 and top-2 with room for every token
(``test_parallel.py:844``, ``:877``), top-2's slots that must not collide
(``:912``), the capacity's drops (``:941``), routing ties (argmax's first
index), the load-balancing loss, and ``MoEFFN``'s output and gradients
(``:963``).  The multi-rank cases run in one gloo gang of four rank
processes (``torch_rank_worker.py`` suite ``moe``, started once for the
module): ``ShardedTrainer`` with ``MOE_EP_RULES`` at ep=2 (top-1, and
top-2 with drops) and dp=2 x ep=2 (top-2 with drops), and at dp=2 with
replicated experts and drops, each rank holding its experts and its block
of the tokens; three SGD steps each against the JAX ``ShardedTrainer`` on one
device (``:986``): the capacity and the routing are the global batch's.

Tolerances: rtol 2e-4 / atol 2e-5 on outputs and losses, 2e-3 / 2e-4 on
gradients and trained parameters.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.contrib import MoEFFN as JMoEFFN
from mxnet_tpu.ops.moe import moe_ffn as jmoe

import torch
import torch_rank_cases as cases
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.contrib import MoEFFN as TMoEFFN
from mxnet_tpu_torch.ops.moe import moe_ffn as tmoe
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The gang, started once for the module and left running while the
    tests compute their JAX references; ``gang.dir()`` waits for it."""
    g = cases.start_gang("moe", tmp_path_factory.mktemp("moe_gang"))
    yield g
    g.close()


def _weights(seed, n, m, f, e, scale=0.1):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, m).astype(np.float32)
    gw = rs.randn(e, m).astype(np.float32)
    w1 = rs.randn(e, m, f).astype(np.float32) * scale
    b1 = rs.randn(e, f).astype(np.float32) * scale
    w2 = rs.randn(e, f, m).astype(np.float32) * scale
    b2 = rs.randn(e, m).astype(np.float32) * scale
    return x, gw, w1, b1, w2, b2


def _both(args, **kw):
    """Both packages' moe_ffn with the Switch loss: (port, JAX) numpy
    pairs."""
    t = tmoe(*(torch.as_tensor(a) for a in args), output_aux_loss=True,
             **kw)
    j = jax.jit(lambda *a: jmoe(*a, output_aux_loss=True, **kw))(
        *(jnp.asarray(a) for a in args))
    return [(np.asarray(a.detach()), np.asarray(b)) for a, b in zip(t, j)]


@pytest.mark.parametrize("k,cf,seed,n", [(1, 12.0, 0, 12), (2, 16.0, 3, 16),
                                         (1, 1.0, 5, 24), (2, 0.75, 6, 24)])
def test_moe_ffn_matches_jax(k, cf, seed, n):
    """test_parallel.py:844, :877: top-1 and top-2 with room for every
    token, and with the capacity dropping tokens: outputs and the
    load-balancing loss."""
    for got, want in _both(_weights(seed, n, 8, 16, 4), num_experts=4, k=k,
                           capacity_factor=cf):
        np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_moe_ffn_top2_slots_do_not_collide():
    """test_parallel.py:912: every token's first pick is expert 0 and its
    second expert 1; expert 1's queue starts after expert 0's kept
    tokens."""
    n, m, e = 4, 4, 2
    x = np.eye(n, m, dtype=np.float32)
    gw = np.array([[3.0] * m, [1.0] * m], np.float32)
    w1 = np.stack([np.eye(m), 2 * np.eye(m)]).astype(np.float32)
    w2 = np.stack([np.eye(m), np.eye(m)]).astype(np.float32)
    zeros = np.zeros((e, m), np.float32)
    args = (x, gw, w1, zeros, w2, zeros)
    (y, jy), _ = _both(args, num_experts=e, k=2, capacity_factor=2.0)
    np.testing.assert_allclose(y, jy, RTOL, ATOL)
    logits = x @ gw.T
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    scale = (probs[:, 0] + 2 * probs[:, 1]) / (probs[:, 0] + probs[:, 1])
    np.testing.assert_allclose(y, x * scale[:, None], atol=1e-5)


def test_moe_ffn_capacity_drops_and_ties():
    """test_parallel.py:941: the router sends every token to expert 0 and
    only the capacity's four are served; tied router logits pick the
    first expert, as argmax does."""
    n, m, e = 8, 4, 2
    x = np.ones((n, m), np.float32)
    w1 = np.ones((e, m, 4), np.float32)
    w2 = np.ones((e, 4, m), np.float32)
    for gw in (np.array([[5.0] * m, [-5.0] * m], np.float32),
               np.ones((e, m), np.float32)):
        args = (x, gw, w1, np.zeros((e, 4), np.float32), w2,
                np.zeros((e, m), np.float32))
        pairs = _both(args, num_experts=e, k=1, capacity_factor=1.0)
        for got, want in pairs:
            np.testing.assert_allclose(got, want, RTOL, ATOL)
        assert (np.abs(pairs[0][0]).sum(axis=1) > 0).sum() == 4


def test_moe_gluon_layer_matches_jax():
    """test_parallel.py:963: MoEFFN (top-2) forward, the stashed Switch
    loss (balanced: >= 1), and the gradients of the input and of every
    parameter, against the JAX layer with the same weights."""
    import mxnet_tpu_torch as tmx

    rs = np.random.RandomState(1)
    x = rs.randn(16, 8).astype(np.float32)
    with cpu():
        tl = TMoEFFN(units=8, hidden=16, num_experts=4, k=2,
                     capacity_factor=2.0, prefix="moe_")
        tl.initialize(init=tmx.init.Xavier())
    jl = JMoEFFN(units=8, hidden=16, num_experts=4, k=2, capacity_factor=2.0,
                 prefix="moe_")
    jl.initialize(init=jmx.init.Xavier())
    vals = {n: rs.randn(*p.shape).astype(np.float32) * 0.3
            for n, p in jl.collect_params().items()}
    for n, v in vals.items():
        jl.collect_params()[n].set_data(jmx.nd.array(v))
        tl.collect_params()[n].set_data(v)
    names = list(vals)

    def jloss(xv, *ps):
        from mxnet_tpu.gluon.block import param_override_scope

        pm = {id(jl.collect_params()[n]): p for n, p in zip(names, ps)}
        with param_override_scope(pm, {}):
            y = jl.forward(xv)
        return jnp.sum(y * y), (y, jl.aux_loss)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names) + 1)), has_aux=True))(
        jnp.asarray(x), *(jnp.asarray(vals[n]) for n in names))
    xt = torch.tensor(x, requires_grad=True)
    params = [tl.collect_params()[n]._value() for n in names]
    ty = tl(xt)
    tg = torch.autograd.grad((ty * ty).sum(), [xt] + params)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), RTOL,
                               ATOL)
    aux = float(tl.aux_loss.detach())
    assert aux >= 0.99
    np.testing.assert_allclose(aux, float(jaux), RTOL, ATOL)
    for name, got, want in zip(["x"] + names, tg, jg):
        assert np.abs(got.numpy()).sum() > 0, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), GRAD_RTOL,
                                   GRAD_ATOL, err_msg=name)


EP_CASES = [("moe_ep2_k1", 1, 4.0, 2, 2), ("moe_ep2_k2_drops", 2, 0.75, 2, 2),
            ("moe_dp2ep2_k2", 2, 0.75, 4, 2),
            ("moe_dp2_k1_drops", 1, 0.5, 2, 4)]


@pytest.fixture(scope="module")
def refs():
    """The JAX trainer's three steps on one device for every (k, capacity
    factor) of ``EP_CASES``, computed while the gang runs."""
    out = {}
    for k, cf in sorted({(k, cf) for _, k, cf, _, _ in EP_CASES}):
        net = cases.moe_net(jmx, k, cf)
        tr = jparallel.ShardedTrainer(net, jmx.gluon.loss.L2Loss(), "sgd",
                                      {"learning_rate": 0.1},
                                      mesh=jparallel.make_mesh(dp=1))
        losses = [float(np.asarray(tr.step(jmx.nd.array(cases.MOE_X),
                                           jmx.nd.array(cases.MOE_Y))._data,
                                   dtype=np.float32))
                  for _ in range(cases.STEPS)]
        tr.sync_params()
        out[(k, cf)] = (losses, {n: p.data().asnumpy()
                                 for n, p in net.collect_params().items()})
    return out


@pytest.mark.parametrize("case,k,cf,ranks,experts", EP_CASES)
def test_moe_expert_parallel_matches_single_device(gang, refs, case, k, cf,
                                                   ranks, experts):
    """test_parallel.py:986: Dense then MoEFFN through ShardedTrainer, each
    rank its experts (MOE_EP_RULES) and its block of the tokens, the
    tokens reaching their experts through all_to_all_single; three SGD
    steps against the JAX trainer on one device."""
    losses, params = refs[(k, cf)]
    for r in range(ranks):
        res = cases.load(gang.dir(), case, r)
        assert set(res["local_experts"].tolist()) == {experts}
        np.testing.assert_allclose(res["losses"], losses, RTOL, ATOL)
        for n, want in params.items():
            np.testing.assert_allclose(res["p:" + n], want, GRAD_RTOL,
                                       GRAD_ATOL, err_msg=n)
