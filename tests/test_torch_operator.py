"""Operator parity: the port's op families against the JAX package's.

For every spec of ``tests/test_operator.py``'s ``SPECS`` (imported
read-only) whose JAX op lives in a family the port has ported, the same
numpy inputs go through ``mxnet_tpu.nd`` (on the CPU) and
``mxnet_tpu_torch.nd`` (under ``with mx.cpu():``):

- forward: values within rtol 1e-4 / atol 1e-5 (``test_operator.py``'s
  own forward tolerance), equal shapes and dtypes; random ops are held to
  shape and dtype only (threefry and Philox draw other numbers;
  ``test_torch_ndarray.py`` holds their moments and seeding);
- gradient: for specs with a finite-difference check, the gradient of
  sum(out * c), c a fixed random cotangent, with respect to each checked
  input, within rtol 2e-3 / atol 2e-4 (ROADMAP's gradient tolerance).

A coverage gate, modelled on ``test_registry_fully_covered``, asks that
every canonical JAX op of those families is registered in the port or
skipped here with a reason.
"""

import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops.registry import all_ops as jax_ops

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops.registry import all_ops as port_ops
from test_operator import SPECS
from torch_one_thread import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)

# The JAX op families the port has; ops registered straight from
# jax.numpy / jax.scipy are ops/elemwise.py's _u/_b tables.
PORTED = {"mxnet_tpu.ops.elemwise", "mxnet_tpu.ops.reduce",
          "mxnet_tpu.ops.matrix", "mxnet_tpu.ops.indexing",
          "mxnet_tpu.ops.random_ops", "mxnet_tpu.ops.nn",
          "mxnet_tpu.ops.optimizer_op", "mxnet_tpu.ops.attention",
          "mxnet_tpu.ops.ctc", "mxnet_tpu.ops.linalg",
          "mxnet_tpu.ops.legacy_output", "mxnet_tpu.ops.rnn",
          "mxnet_tpu.ops.contrib_det", "mxnet_tpu.ops.vision_extra",
          "mxnet_tpu.ops.moe", "mxnet_tpu.ops.quantization"}
RANDOM = "mxnet_tpu.ops.random_ops"

#: canonical JAX ops of the ported families the port leaves out, by reason
PORT_SKIP = {}


def _family(name):
    mod = jax_ops()[name].fn.__module__
    return "mxnet_tpu.ops.elemwise" if mod.startswith("jax") else mod


def _canonical(names):
    prim = {}
    for n, d in sorted(jax_ops().items()):
        prim.setdefault(d.fn, d.name if d.name in jax_ops() else n)
    return sorted(n for n in set(prim.values()) if n in names)


CANONICAL = _canonical({n for n in jax_ops() if _family(n) in PORTED})
CASES = sorted(n for n in SPECS if n in jax_ops() and _family(n) in PORTED
               and n not in PORT_SKIP)


def test_ported_families_fully_covered():
    missing = [n for n in CANONICAL
               if n not in port_ops() and n not in PORT_SKIP]
    assert not missing, f"JAX ops of ported families missing: {missing}"
    assert len(CANONICAL) >= 100, len(CANONICAL)
    assert set(CASES) <= set(port_ops())


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _run(nd, name, spec):
    args = [nd.array(a) if isinstance(a, np.ndarray) else a
            for a in spec.args]
    return _outs(getattr(nd, name)(*args, **spec.kwargs))


@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax(name):
    spec = SPECS[name]
    want = _run(jnd, name, spec)
    with tmx.cpu():
        got = _run(tnd, name, spec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.dtype(g.dtype) == np.dtype(w.dtype), (name, g.dtype,
                                                        w.dtype)
        if _family(name) != RANDOM:
            np.testing.assert_allclose(
                g.asnumpy().astype(np.float64),
                np.asarray(w.asnumpy()).astype(np.float64),
                err_msg=name, **FWD_TOL)


def _grads(nd, ag, name, spec, argnums, cots):
    args = [nd.array(a) if isinstance(a, np.ndarray) else a
            for a in spec.args]
    for i in argnums:
        args[i].attach_grad()
    with ag.record():
        outs = _outs(getattr(nd, name)(*args, **spec.kwargs))
        loss = None
        for o, c in zip(outs, cots):
            term = (o * nd.array(c)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [args[i].grad.asnumpy() for i in argnums]


def _jax_grads(name, spec, argnums, cots):
    """The JAX op's gradients of sum(out * c) as its NDArray tape takes
    them (``jax.vjp`` of the registered function, training mode, on the
    arrays ``nd.array`` makes), compiled as one program instead of an
    operator and its transpose at a time.  Opaque and random ops keep
    the NDArray path."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import get as jax_op

    opdef = jax_op(name)
    if opdef.opaque or opdef.random:
        return _grads(jnd, jag, name, spec, argnums, cots)
    kwargs = dict(spec.kwargs)
    if opdef.mode_dependent:
        kwargs["_is_training"] = True
    slots = [i for i, a in enumerate(spec.args) if isinstance(a, np.ndarray)]

    def pure(*arrays):
        args = list(spec.args)
        for i, a in zip(slots, arrays):
            args[i] = a
        return opdef.fn(*args, **kwargs)

    def pullback(*arrays):
        out, pull = jax.vjp(pure, *arrays)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        cts = [jnp.asarray(c, o.dtype) for o, c in zip(outs, cots)]
        return pull(type(out)(cts) if isinstance(out, (tuple, list))
                    else cts[0])

    grads = jax.jit(pullback)(*[jnd.array(spec.args[i])._data
                                for i in slots])
    return [np.asarray(grads[slots.index(i)]) for i in argnums]


@pytest.mark.parametrize("name", [n for n in CASES if SPECS[n].fd])
def test_gradient_matches_jax(name):
    spec = SPECS[name]
    argnums = spec.fd_argnums if spec.fd_argnums is not None else [
        i for i, a in enumerate(spec.args) if isinstance(a, np.ndarray)]
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes = [o.shape for o in _run(jnd, name, spec)]
    cots = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = _jax_grads(name, spec, argnums, cots)
    with tmx.cpu():
        got = _grads(tnd, tag, name, spec, argnums, cots)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)
