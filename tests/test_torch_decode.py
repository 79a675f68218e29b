"""The port's model-level decoders on the CPU against the JAX package's, on
the same weights (gpt_tiny through ``convert.load_state``) and the same
numpy seeds: ``CachedDecoder.decode`` (tokens equal, logits within the
reference's rtol 2e-4 / atol 1e-5, bf16 within its 0.05 of max|logit|),
``speculative_decode`` (lossless under the reference's rule, the same
accepted-token count as JAX's) and ``beam_generate`` (tokens equal,
scores within rtol 1e-4), plus the decode tool's line."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, serving as jserving
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import model_zoo
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from torch_one_thread import one_torch_thread  # noqa: F401


def _pair(seed=7, layers=2, max_length=32):
    """A JAX gpt_tiny (scanned trunk, Xavier from ``seed``) and the port's
    per-layer gpt_tiny holding the same weights."""
    mx.random.seed(seed)
    net = jgpt.gpt_tiny(scan_layers=True, max_length=max_length,
                        num_layers=layers)
    net.initialize(init=mx.init.Xavier())
    net(nd.array(np.zeros((1, 4), np.float32)))
    model = tgpt.gpt_tiny(max_length=max_length, num_layers=layers,
                          device=cpu())
    convert.load_state(model, jserving.state_for_serving(net))
    return net, model


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, 128, shape)


def _assert_decode_equiv(ref_t, ref_lg, got_t, got_lg, T0):
    """The reference's rule: first logits within rtol 2e-4 / atol 1e-5;
    tokens equal, or parting only where the logits agree to that
    tolerance (a rounding tie)."""
    np.testing.assert_allclose(got_lg[0], ref_lg[0], rtol=2e-4, atol=1e-5)
    if np.array_equal(ref_t, got_t):
        return
    j = int(np.argwhere((ref_t != got_t).any(axis=0))[0, 0]) - T0
    np.testing.assert_allclose(got_lg[j], ref_lg[j], rtol=2e-4, atol=1e-5,
                               err_msg=f"tokens diverged at step {j}")


def test_cached_decoder_matches_jax():
    net, model = _pair()
    ids = _ids(0, (2, 6))
    ref_t, ref_lg = jgpt.CachedDecoder(net).decode(
        nd.array(ids.astype(np.float32)), max_new_tokens=5,
        return_logits=True)
    got_t, got_lg = tgpt.CachedDecoder(model).decode(
        ids, max_new_tokens=5, return_logits=True)
    assert got_t.shape == (2, 11) and got_lg.shape == (5, 2, 128)
    assert got_t.dtype == np.float32
    _assert_decode_equiv(ref_t.asnumpy(), ref_lg, got_t.asnumpy(), got_lg,
                         T0=6)
    # the cached path and the port's full recompute agree too
    np.testing.assert_array_equal(
        tgpt.generate(model, ids, max_new_tokens=5).asnumpy(),
        got_t.asnumpy())


def test_cached_decoder_bf16_within_the_references_tolerance():
    """dtype="bfloat16": the matrix stacks, tables and cache in bf16,
    accumulation in f32; the first logits within 0.05 max|f32 logit| of
    the JAX f32 decoder's, as the reference holds its own bf16 decoder."""
    net, model = _pair(seed=9)
    ids = _ids(2, (2, 6))
    _, ref_lg = jgpt.CachedDecoder(net).decode(
        nd.array(ids.astype(np.float32)), max_new_tokens=3,
        return_logits=True)
    dec = tgpt.CachedDecoder(model, dtype="bfloat16")
    toks, lg = dec.decode(ids, max_new_tokens=3, return_logits=True)
    assert toks.shape == (2, 9)
    assert dec._init_cache(2)[0].dtype == torch.bfloat16
    assert dec._w["qkv"].dtype == torch.bfloat16
    assert dec._w["ln1_g"].dtype == torch.float32
    scale = np.abs(ref_lg[0]).max()
    np.testing.assert_allclose(lg[0], ref_lg[0], atol=0.05 * scale)


def test_cached_decoder_refuses_what_it_cannot_do():
    """A tp axis that does not divide the heads and the FFN width raises
    (the reference's check), as does a seed past the window."""
    from types import SimpleNamespace

    _, model = _pair()
    mesh = SimpleNamespace(shape={"tp": 3}, is_rank_mesh=True)
    with pytest.raises(MXNetError, match="must divide num_heads"):
        tgpt.CachedDecoder(model, mesh=mesh)
    with pytest.raises(ValueError, match="cache window"):
        tgpt.CachedDecoder(model).decode(_ids(0, (1, 30)), max_new_tokens=3)


def _assert_lossless(spec, ref, ref_lg, T0):
    """Token-exact, except a divergence where the reference's top-2
    margin is inside 1e-3 max|logit| (tests/test_model_zoo.py's rule)."""
    if np.array_equal(spec, ref):
        return
    j = int(np.argwhere((spec != ref).any(axis=0))[0, 0]) - T0
    top2 = np.sort(ref_lg[j], axis=-1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    assert margin < 1e-3 * np.abs(ref_lg[j]).max(), \
        f"diverged at step {j} with a decisive margin {margin}"


def test_speculative_decode_lossless_and_like_jax():
    """Self-draft: lossless, every untrimmed proposal accepted.  An
    independent draft: lossless, and the same rounds and accepted tokens
    as the JAX package's speculative_decode on the same weights."""
    jtgt, tgt = _pair(seed=5, max_length=64)
    jdrf, drf = _pair(seed=6, max_length=64)
    ids = _ids(5, (3, 7))
    ref_t, ref_lg = tgpt.CachedDecoder(tgt).decode(
        ids, max_new_tokens=9, return_logits=True)
    ref = ref_t.asnumpy()
    spec, st = tgpt.speculative_decode(tgt, tgt, ids, max_new_tokens=9, k=3,
                                       return_stats=True)
    assert spec.dtype == np.float32
    _assert_lossless(spec.asnumpy(), ref, ref_lg, 7)
    assert st["accepted_draft_tokens"] >= 6     # all accepted up to trim
    spec2, st2 = tgpt.speculative_decode(tgpt.CachedDecoder(tgt), drf, ids,
                                         max_new_tokens=9, k=3,
                                         return_stats=True)
    _assert_lossless(spec2.asnumpy(), ref, ref_lg, 7)
    assert st2["rounds"] >= st["rounds"]
    jspec, jst = jgpt.speculative_decode(jtgt, jdrf,
                                         nd.array(ids.astype(np.float32)),
                                         max_new_tokens=9, k=3,
                                         return_stats=True)
    np.testing.assert_array_equal(spec2.asnumpy(), jspec.asnumpy())
    assert st2 == jst
    with pytest.raises(ValueError, match="cache window"):
        tgpt.speculative_decode(tgt, drf, _ids(0, (1, 51)),
                                max_new_tokens=10, k=4)


def _record_rounds(dec, k):
    """Wrap a target CachedDecoder's block step: each (k+1)-token verify
    step appends the batch's accepted prefix m (the rows' smallest run of
    proposals the target's greedy picks agree with) to the list
    returned."""
    step, rounds = dec._step, []

    def wrapped(ck, cv, pos, toks):
        logits = step(ck, cv, pos, toks)
        if toks.shape[1] == k + 1:
            agree = (toks[:, 1:] == logits[:, :k].argmax(dim=-1)).numpy()
            rounds.append(int(np.where(agree.all(axis=1), k,
                                       np.argmin(agree, axis=1)).min()))
        return logits

    dec._step = wrapped
    return rounds


def test_speculative_decode_partial_acceptance_like_jax():
    """A draft that agrees with the target part of the time (the target's
    weights plus 0.3 std of seeded noise): rounds that accept some
    proposals and not all run, the rows advance at the batch's smallest
    acceptance, and the tokens and stats equal the JAX package's on the
    same weights; lossless against the port's own decoder."""
    jtgt, tgt = _pair(seed=5, max_length=64)
    jdrf, _ = _pair(seed=5, max_length=64)
    rng = np.random.RandomState(17)
    noisy = {k: (v + 0.3 * v.std() * rng.standard_normal(v.shape))
             .astype(np.float32)
             for k, v in jserving.state_for_serving(jdrf).items()}
    for k, p in jdrf.collect_params().items():
        p.set_data(nd.array(noisy[k]))
    drf = tgpt.gpt_tiny(max_length=64, num_layers=2, device=cpu())
    convert.load_state(drf, noisy)
    ids = _ids(5, (3, 7))
    dec = tgpt.CachedDecoder(tgt)
    ref_t, ref_lg = dec.decode(ids, max_new_tokens=9, return_logits=True)
    accepted = _record_rounds(dec, 3)
    spec, st = tgpt.speculative_decode(dec, drf, ids, max_new_tokens=9, k=3,
                                       return_stats=True)
    assert any(0 < m < 3 for m in accepted), accepted
    assert st["rounds"] == len(accepted)
    _assert_lossless(spec.asnumpy(), ref_t.asnumpy(), ref_lg, 7)
    jspec, jst = jgpt.speculative_decode(jtgt, jdrf,
                                         nd.array(ids.astype(np.float32)),
                                         max_new_tokens=9, k=3,
                                         return_stats=True)
    np.testing.assert_array_equal(spec.asnumpy(), jspec.asnumpy())
    assert st == jst


def test_beam_generate_matches_jax():
    net, model = _pair(seed=3, max_length=16)
    ids = _ids(4, (2, 5))
    jt, js = jgpt.beam_generate(net, nd.array(ids.astype(np.float32)),
                                max_new_tokens=4, beam_size=3, alpha=0.6)
    got, scores = tgpt.beam_generate(model, ids, max_new_tokens=4,
                                     beam_size=3, alpha=0.6)
    assert got.shape == (2, 9) and scores.shape == (2,)
    np.testing.assert_array_equal(got.asnumpy(), jt.asnumpy())
    np.testing.assert_allclose(scores, js, rtol=1e-4)
    # beam 1 is greedy decoding
    b1, _ = tgpt.beam_generate(model, ids, max_new_tokens=4, beam_size=1)
    np.testing.assert_array_equal(
        b1.asnumpy(), tgpt.generate(model, ids, max_new_tokens=4).asnumpy())


def test_zoo_exports():
    assert model_zoo.CachedDecoder is tgpt.CachedDecoder
    assert model_zoo.speculative_decode is tgpt.speculative_decode
    assert model_zoo.gpt.beam_generate is tgpt.beam_generate
    assert model_zoo.transformer.transformer_base is not None


def test_bench_decode_tool_on_the_host():
    """tools.bench_decode.run's line on gpt_tiny on the CPU: the cached
    f32 tokens equal generate()'s, bf16 within the reference's 0.05."""
    from mxnet_tpu_torch.tools import bench_decode

    _, model = _pair(max_length=64)
    res = bench_decode.run(model)
    assert res["config"]["batch"] == 8 and res["config"]["new_tokens"] == 48
    assert res["kv_cache_tokens_equal_recompute"] is True
    assert res["bf16_first_logits_err_over_scale"] <= 0.05
    assert res["kv_cache_tokens_per_sec"] > 0 and res["nvidia_smi"] is None
