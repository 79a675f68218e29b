"""``test_utils``, ``runtime`` and ``storage`` of the PyTorch port against
the JAX package's: the test helpers on the same inputs, ``Features``' keys
and honest values, and the memory knobs' mapping onto PyTorch's caching
allocator, read in a fresh process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu import runtime as jruntime
from mxnet_tpu import storage as jstorage
from mxnet_tpu import test_utils as jtu
import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import runtime as truntime
from mxnet_tpu_torch import storage as tstorage
from mxnet_tpu_torch import test_utils as ttu
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_default_context_and_gpus(monkeypatch):
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CONTEXT", "cpu(0)")
    assert str(ttu.default_context()) == str(jtu.default_context())
    assert ttu.default_context() == cpu()
    monkeypatch.delenv("MXNET_TEST_DEFAULT_CONTEXT")
    with cpu():
        assert ttu.default_context() == cpu()
    want = list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []
    assert ttu.list_gpus() == want
    assert ttu.discover_type("float16") == jtu.discover_type("float16")
    assert ttu.default_dtype() == jtu.default_dtype()


def test_comparisons_match_jax():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    for b, rtol, atol in ((a + 1e-6, None, None), (a + 1e-3, None, None),
                          (a * 1.001, 1e-2, 0.0), (a + 0.5, 1e-5, 0.1)):
        assert ttu.almost_equal(a, b, rtol, atol) == \
            jtu.almost_equal(a, b, rtol, atol)
        results = []
        for tu in (ttu, jtu):
            try:
                tu.assert_almost_equal(a, b, rtol, atol)
                results.append(True)
            except AssertionError:
                results.append(False)
        assert results[0] == results[1], (b, rtol, atol)
    assert ttu.same(a, a.copy()) and not ttu.same(a, a + 1)
    with cpu():
        assert ttu.same(tmx.nd.array(a), a)
        ttu.assert_almost_equal(torch.from_numpy(a), a.astype(np.float64))
    with pytest.raises(AssertionError):
        ttu.assert_almost_equal(np.float16([1, 2]), np.float16([1, 2.1]))


def test_random_helpers_match_jax():
    """The same numpy seed gives the same shapes and values."""
    for tu in (ttu, jtu):
        np.random.seed(7)
        if tu is ttu:
            with cpu():
                got = (tu.rand_shape_nd(3), tu.random_arrays((2, 3), (4,)),
                       tu.rand_ndarray((3, 2), scale=2.0).asnumpy())
        else:
            want = (tu.rand_shape_nd(3), tu.random_arrays((2, 3), (4,)),
                    tu.rand_ndarray((3, 2), scale=2.0).asnumpy())
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])


def _sq_sum(nd_mod):
    return lambda x, y: nd_mod.broadcast_mul(x, x) + nd_mod.sin(y)


def test_gradient_and_symbolic_checks_match_jax():
    """check_numeric_gradient passes on a right gradient in both packages;
    check_symbolic_forward/backward and simple_forward agree with numpy."""
    rs = np.random.RandomState(0)
    x, y = rs.randn(3, 2), rs.randn(3, 2)
    with cpu():
        ttu.check_numeric_gradient(_sq_sum(tmx.nd), [x, y], eps=1e-2)
        ttu.check_symbolic_forward(_sq_sum(tmx.nd), [x, y],
                                   [x * x + np.sin(y)])
        ttu.check_symbolic_backward(_sq_sum(tmx.nd), [x, y],
                                    [np.ones((3, 2))],
                                    [2 * x, np.cos(y)])
        got = ttu.simple_forward(tmx.nd.sin, x.astype(np.float32))
    jtu.check_numeric_gradient(_sq_sum(mx.nd), [x, y], eps=1e-2)
    want = jtu.simple_forward(mx.nd.sin, x.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with cpu(), pytest.raises(AssertionError):
        ttu.check_symbolic_forward(_sq_sum(tmx.nd), [x, y], [x * x])


def test_check_consistency_on_the_host():
    """On the host only the ``cpu`` backend runs (a ``gpu`` backend is left
    out when there is no card): one result, the function's outputs; the
    JAX package's oracle gives the same numbers."""
    from mxnet_tpu_torch.ops import quantization as tq

    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    got = ttu.check_consistency(lambda t: tq.quantize_v2(t), [x],
                                backends=("cpu", "gpu"), rtol=0, atol=0)
    assert [b for b, _ in got][0] == "cpu"
    assert len(got) == (2 if torch.cuda.is_available() else 1)
    want = jtu.check_consistency(lambda t: jnp_quantize(t), [x])
    np.testing.assert_array_equal(got[0][1][0], want[0][1])


def jnp_quantize(t):
    from mxnet_tpu.ops import quantization as jq

    return jq.quantize_v2(t)[0]


def test_features_keys_and_values():
    tf, jf = truntime.Features(), jruntime.Features()
    assert list(tf) == list(jf)
    assert [f.name for f in truntime.feature_list()] == list(jf)
    assert not tf.is_enabled("TPU") and not tf.is_enabled("xla")
    assert not tf.is_enabled("ICI_COLLECTIVES")
    assert tf.is_enabled("CUDA") == torch.cuda.is_available()
    from mxnet_tpu_torch import _kernels

    if not set(_kernels.SOURCES) <= set(_kernels._LIBS):
        assert not tf.is_enabled("PALLAS")
    with pytest.raises(RuntimeError):
        tf.is_enabled("NOT_A_FEATURE")
    assert "PALLAS" in repr(tf["PALLAS"])


_CHILD = """
import json, os, sys
import mxnet_tpu_torch, torch
from mxnet_tpu_torch import storage
print(json.dumps({"settings": storage.settings(),
                  "no_caching": os.environ.get(
                      "PYTORCH_NO_CUDA_MEMORY_CACHING"),
                  "cuda_started": torch.cuda.is_initialized()}))
"""


KNOBS = {
    "all": ({"MXNET_TPU_MEM_FRACTION": "0.5",
             "MXNET_TPU_ALLOCATOR": "platform",
             "MXNET_TPU_PREALLOCATE": "true"},
            ({"memory_fraction": 0.5, "preallocate": True, "caching": False},
             "1")),
    "explicit_torch_setting_wins": (
        {"MXNET_TPU_ALLOCATOR": "platform",
         "PYTORCH_NO_CUDA_MEMORY_CACHING": "0"},
        ({"memory_fraction": None, "preallocate": False, "caching": True},
         "0")),
    "none": ({}, ({"memory_fraction": None, "preallocate": False,
                   "caching": True}, None)),
}


@pytest.fixture(scope="module")
def knob_children():
    """One fresh process a case, all started together."""
    procs = {}
    for case, (knobs, _want) in KNOBS.items():
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("MXNET_TPU_", "PYTORCH_NO_CUDA"))}
        env.update(knobs, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs[case] = subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {case: p.communicate(timeout=120) + (p.returncode,)
            for case, p in procs.items()}


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_storage_knobs_in_a_fresh_process(knob_children, case):
    """The knobs are read at import, before anything starts CUDA, and an
    explicit PyTorch setting wins; importing starts no CUDA context."""
    out, err, rc = knob_children[case]
    assert rc == 0, err[-2000:]
    got = json.loads(out.strip().splitlines()[-1])
    assert (got["settings"], got["no_caching"]) == KNOBS[case][1]
    assert got["cuda_started"] is False


def test_memory_info_on_the_host():
    assert tstorage.memory_info(cpu()) == (None, None) == \
        jstorage.memory_info(mx.cpu())
    assert tstorage.memory_summary(cpu()) == \
        "device exposes no memory statistics"
    if not torch.cuda.is_available():
        assert tstorage.memory_info() == (None, None)
