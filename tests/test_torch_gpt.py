"""The port's GPT model against the JAX package's, on the CPU: the same
weights (JAX Xavier init, carried across by ``convert``) and the same
numpy tokens through both.  Logits at rtol 2e-4 / atol 2e-5 as
tests/test_model_zoo.py's trunk equivalence; greedy tokens equal."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, serving
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import flash_attention as tflash
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


_SHARED = {}


def _jax_gpt(scan, impl, seed=0, **kwargs):
    """gpt_tiny with Xavier weights and random (not zero/one) biases and
    LayerNorm parameters, so every parameter is exercised; hybridized
    (one compiled program a shape), and built once for each
    configuration: the tests only read it."""
    key = (scan, impl, seed, tuple(sorted(kwargs.items())))
    if key in _SHARED:
        return _SHARED[key]
    mx.random.seed(seed)
    net = jgpt.gpt_tiny(scan_layers=scan, attention_impl=impl, **kwargs)
    net.initialize(init=mx.init.Xavier())
    net.hybridize()
    net(nd.array(np.zeros((1, 4), np.float32)))
    rng = np.random.RandomState(seed + 1)
    for name, p in net.collect_params().items():
        if name.endswith(("bias", "beta", "gamma")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(nd.array(
                base + 0.1 * rng.randn(*p.shape).astype(np.float32)))
    _SHARED[key] = net
    return net


def _port_of(net, scan, impl, **kwargs):
    model = tgpt.gpt_tiny(attention_impl=impl, scan_layers=scan,
                          device=cpu(), **kwargs)
    if scan:
        convert.load_state(model, serving.state_for_serving(net))
    else:
        stacks, lnf, tok, pos, _, _ = jgpt.extract_decoder_stacks(net)
        convert.load_stacks(
            model, {k: np.asarray(v) for k, v in stacks.items()},
            tuple(np.asarray(x) for x in lnf), np.asarray(tok),
            np.asarray(pos))
    return model


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("scan", [True, False])
def test_gpt_logits_match_jax(scan, impl):
    net = _jax_gpt(scan, impl)
    model = _port_of(net, scan, impl)
    ids = np.random.RandomState(1).randint(0, 128, (2, 16))
    want = net(nd.array(ids.astype(np.float32))).asnumpy()
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 16, 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_generate_matches_jax(impl):
    """Greedy decode over the right-padded window: the port's tokens, a
    float32 NDArray as the JAX package's, equal the JAX package's, and
    the flash run on the CPU launches no kernel."""
    net = _jax_gpt(True, impl, max_length=32)
    model = _port_of(net, True, impl, max_length=32)
    ids = np.random.RandomState(2).randint(0, 128, (2, 6))
    want = jgpt.generate(net, nd.array(ids.astype(np.float32)),
                         max_new_tokens=5).asnumpy()
    before = tflash.flash_attention_fwd.launches
    got = tgpt.generate(model, ids, max_new_tokens=5)
    assert tflash.flash_attention_fwd.launches == before
    assert isinstance(got, tnd.NDArray) and got.shape == (2, 11)
    assert got.dtype == np.float32 == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_generate_samples_with_a_generator():
    """Temperature sampling draws from the given torch.Generator: the
    same seed gives the same tokens."""
    from mxnet_tpu_torch import random

    model = tgpt.gpt_tiny(device=cpu())
    ids = torch.randint(0, 128, (2, 4), generator=random.generator(0))
    a = tgpt.generate(model, ids, 4, temperature=1.0,
                      generator=random.generator(3))
    b = tgpt.generate(model, ids, 4, temperature=1.0,
                      generator=random.generator(3))
    assert np.array_equal(a.asnumpy(), b.asnumpy()) and a.shape == (2, 8)


def _state(net):
    return serving.state_for_serving(net)


@pytest.mark.parametrize("mutate,err,match", [
    (lambda s: s.pop(next(k for k in s if k.endswith("lnf_beta"))),
     MXNetError, "no entry ending 'lnf_beta'"),
    (lambda s: s.__setitem__("extra_ffn1_stack_bias",
                             s[next(k for k in s
                                    if k.endswith("ffn1_stack_bias"))]),
     MXNetError, "2 entries end 'ffn1_stack_bias'"),
    (lambda s: s.__setitem__(next(k for k in s
                                  if k.endswith("qkv_stack_weight")),
                             np.zeros((2, 96, 31), np.float32)),
     MXNetError, "qkv_stack_weight.*shape"),
    (lambda s: s.__setitem__(next(k for k in s
                                  if k.endswith("tok_embed_weight")),
                             [[0.0]]),
     TypeError, "numpy array"),
])
def test_load_state_rejects_bad_entries(mutate, err, match):
    net = _jax_gpt(True, "dense")
    state = _state(net)
    mutate(state)
    model = tgpt.gpt_tiny(device=cpu())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(err, match=match):
        convert.load_state(model, state)
    # checked before copying: nothing was half loaded
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_load_stacks_rejects_bad_entries():
    net = _jax_gpt(False, "dense")
    stacks, lnf, tok, pos, _, _ = jgpt.extract_decoder_stacks(net)
    stacks = {k: np.asarray(v) for k, v in stacks.items()}
    lnf = tuple(np.asarray(x) for x in lnf)
    tok, pos = np.asarray(tok), np.asarray(pos)
    model = tgpt.gpt_tiny(device=cpu())
    missing = dict(stacks)
    del missing["ln2_stack_beta"]
    with pytest.raises(MXNetError, match="missing stacks.*ln2_stack_beta"):
        convert.load_stacks(model, missing, lnf, tok, pos)
    with pytest.raises(MXNetError, match="pos_embed_weight.*shape"):
        convert.load_stacks(model, stacks, lnf, tok, pos[:10])
    with pytest.raises(MXNetError, match="ffn2_stack_weight.*shape"):
        bad = dict(stacks, ffn2_stack_weight=stacks["ffn2_stack_weight"][:1])
        convert.load_stacks(model, bad, lnf, tok, pos)


def test_model_refuses_training_features():
    """LoRA and remat train as in the JAX package: a scanned gpt_tiny
    with ``lora_rank`` (B non-zero) gives the JAX logits, the per-layer
    trunk refuses the adapters as there, and ``remat=True`` leaves the
    logits and every gradient unchanged at dropout 0.1 (the recompute
    takes the forward's masks).  Dropout follows training mode: predict
    mode ignores it, training mode drops with the scope's generator (the
    same generator seed gives the same logits)."""
    from mxnet_tpu_torch import autograd, random

    net = _jax_gpt(True, "dense", lora_rank=4)
    rng = np.random.RandomState(7)
    for name, p in net.collect_params().items():
        if "lora" in name:
            p.set_data(nd.array(0.1 * rng.randn(*p.shape).astype(
                np.float32)))
    lora = tgpt.gpt_tiny(device=cpu(), scan_layers=True, lora_rank=4)
    convert.load_gluon_params(lora, {
        n: p.data().asnumpy() for n, p in net.collect_params().items()})
    ids = np.random.RandomState(1).randint(0, 128, (2, 16))
    np.testing.assert_allclose(
        lora(torch.from_numpy(ids)).detach().numpy(),
        net(nd.array(ids.astype(np.float32))).asnumpy(), rtol=RTOL,
        atol=ATOL)
    with pytest.raises(ValueError, match="scan_layers=True"):
        tgpt.gpt_tiny(device=cpu(), lora_rank=4)

    plain = tgpt.gpt_tiny(device=cpu(), scan_layers=True, dropout=0.1)
    remat = tgpt.gpt_tiny(device=cpu(), scan_layers=True, dropout=0.1,
                          remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(ids)
    grads = []
    for model in (plain, remat):
        with autograd.train_mode(), \
                random.generator_scope(random.generator(11)):
            loss = tgpt.GPTLMLoss()(model(x), x)
        ps = [p._value() for p in model.collect_params().values()]
        grads.append((loss, torch.autograd.grad(loss, ps)))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)

    model = tgpt.gpt_tiny(device=cpu(), dropout=0.1)
    ids = torch.randint(0, 128, (2, 8), generator=random.generator(0))
    ref = model(ids)                                 # predict: no dropout
    assert torch.equal(ref, model(ids))
    runs = []
    for seed in (1, 1, 2):
        with autograd.train_mode(), \
                random.generator_scope(random.generator(seed)):
            runs.append(model(ids))
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], ref)
    assert not torch.allclose(runs[0], runs[2])
