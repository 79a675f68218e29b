"""The port's ServingEngine on the CPU: against the JAX engine on the
same weights and prompts, coalesced against one-by-one, against the
port's own generate(), hot reload, and the bf16 path."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, serving as jserving
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serving import ServingEngine


def _jax_model(seed=7, max_length=16):
    mx.random.seed(seed)
    net = jgpt.gpt_tiny(scan_layers=True, max_length=max_length)
    net.initialize(init=mx.init.Xavier())
    net(nd.array(np.zeros((1, 4), np.float32)))
    return net


def _port_model(net, max_length=16, impl="dense", scan=False):
    """The port's gpt_tiny (the per-layer trunk unless ``scan``) with the
    JAX net's serving checkpoint loaded."""
    model = tgpt.gpt_tiny(max_length=max_length, attention_impl=impl,
                          scan_layers=scan, device=cpu())
    convert.load_state(model, jserving.state_for_serving(net))
    return model


def _prompts(n, rng, lo=2, hi=8):
    return [rng.randint(0, 128, rng.randint(lo, hi + 1)).tolist()
            for _ in range(n)]


def test_serve_group_matches_jax_engine():
    net = _jax_model()
    prompts = _prompts(3, np.random.RandomState(3))
    want, _ = jserving.ServingEngine(net, batch_buckets=(4,)) \
        .serve_group(prompts, 5)
    got, timings = ServingEngine(_port_model(net), batch_buckets=(4,)) \
        .serve_group(prompts, 5)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert timings["bucket"] == [4, 8]
    assert 0 <= timings["padded_fraction"] < 1


def test_coalesced_equals_one_by_one():
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(1, 2, 4))
    rng = np.random.RandomState(4)
    prompts = _prompts(3, rng, lo=2, hi=11)      # buckets 8 and 16 mixed
    grouped, _ = eng.serve_group(prompts, [3, 5, 4])
    for i, p in enumerate(prompts):
        solo = eng.serve_group([p], [3, 5, 4][i])[0][0]
        np.testing.assert_array_equal(grouped[i], solo,
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_engine_matches_generate(impl, scan):
    """The cached engine and the full-recompute generate() reach the
    same greedy tokens, on either trunk layout (the engine takes the
    per-layer trunk's weights through extract_decoder_stacks);
    generate() may run the flash trunk."""
    model = _port_model(_jax_model(max_length=32), max_length=32, impl=impl,
                        scan=scan)
    prompts = _prompts(2, np.random.RandomState(5), lo=6, hi=6)
    got, _ = ServingEngine(model, batch_buckets=(2,)).serve_group(prompts, 6)
    ref = tgpt.generate(model, np.asarray(prompts), max_new_tokens=6)
    np.testing.assert_array_equal(np.stack(got), ref.asnumpy()[:, 6:])


def test_reload_from_state_swaps_weights():
    a, b = _jax_model(seed=7), _jax_model(seed=8)
    prompts = _prompts(2, np.random.RandomState(6))
    eng = ServingEngine(_port_model(a), batch_buckets=(2,))
    eng.reload_from_state(jserving.state_for_serving(b))
    assert eng.generation == 1
    got, _ = eng.serve_group(prompts, 4)
    want, _ = ServingEngine(_port_model(b), batch_buckets=(2,)) \
        .serve_group(prompts, 4)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    wider = jserving.state_for_serving(_jax_model(max_length=32))
    with pytest.raises(MXNetError, match="weight mismatch"):
        eng.reload_from_state(wider)
    assert eng.generation == 1


def test_bf16_serving_runs():
    """dtype=bfloat16: matrices, embedding tables and cache in bf16,
    reductions in f32; tokens are valid and coalescing still holds."""
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(4,),
                        dtype=torch.bfloat16)
    ck, _ = eng.init_cache(4)
    assert ck.dtype == torch.bfloat16
    prompts = _prompts(3, np.random.RandomState(7))
    grouped, _ = eng.serve_group(prompts, 4)
    for i, p in enumerate(prompts):
        assert grouped[i].shape == (4,)
        assert ((grouped[i] >= 0) & (grouped[i] < 128)).all()
        np.testing.assert_array_equal(grouped[i],
                                      eng.serve_group([p], 4)[0][0])


def test_engine_samples_with_a_generator():
    """Temperature sampling draws from the given torch.Generator: the
    same seed gives the same tokens."""
    from mxnet_tpu_torch import random

    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(2,))
    prompts = _prompts(2, np.random.RandomState(8))
    a, _ = eng.serve_group(prompts, 5, temperature=0.7,
                           generator=random.generator(1))
    b, _ = eng.serve_group(prompts, 5, temperature=0.7,
                           generator=random.generator(1))
    for x, y in zip(a, b):
        assert x.shape == (5,)
        np.testing.assert_array_equal(x, y)


def test_serve_group_rejects_bad_requests():
    eng = ServingEngine(_port_model(_jax_model()), batch_buckets=(2,))
    with pytest.raises(MXNetError, match="exceeds the largest bucket"):
        eng.serve_group([[1], [2], [3]], 2)
    with pytest.raises(MXNetError, match="cache window"):
        eng.serve_group([[1] * 12], 8)
    with pytest.raises(MXNetError, match="empty prompt"):
        eng.serve_group([[]], 2)
    with pytest.raises(MXNetError, match="positive"):
        eng.serve_group([[1]], 0)
