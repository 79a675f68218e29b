"""The port's encoder-decoder Transformer on the CPU against the JAX
package's, on the same weights (``convert.load_transformer_params``) and
numpy inputs: logits (rtol 2e-4 / atol 2e-5) and every gradient (2e-3 /
2e-4) with dense and flash self-attention (the flash impl on its plain
path here, the JAX one in interpret mode), ``LabelSmoothedCELoss`` with
``ignore_index``, the causal decoder, three eager Gluon training steps,
``greedy_decode`` and ``beam_search``."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd, gluon as jgluon, nd
from mxnet_tpu.gluon.model_zoo import transformer as jtfm
from mxnet_tpu_torch import autograd, convert, gluon
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import transformer as tfm
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from torch_one_thread import one_torch_thread  # noqa: F401

V = 20


_JAX_NETS = {}


def _pair(impl="dense", seed=0, max_length=16):
    """A JAX transformer_tiny (Xavier from ``seed``, hybridized: one
    compile a shape) and the port's holding the same weights, both at
    dropout 0.  One hybridized JAX net serves every test of an (impl,
    max_length): a seed's weights are drawn into a fresh net and copied
    into it, so its compiled programs carry over."""
    mx.random.seed(seed)
    fresh = jtfm.transformer_tiny(V, V, dropout=0.0, max_length=max_length,
                                  attention_impl=impl)
    fresh.initialize(init=mx.init.Xavier())
    key = (impl, max_length)
    if key not in _JAX_NETS:
        fresh.hybridize()
        _JAX_NETS[key] = fresh
    net = _JAX_NETS[key]
    if net is not fresh:
        for p, q in zip(net.collect_params().values(),
                        fresh.collect_params().values()):
            p.set_data(q.data())
    model = tfm.transformer_tiny(V, V, dropout=0.0, max_length=max_length,
                                 attention_impl=impl, device=cpu())
    convert.load_transformer_params(
        model, {k: p.data().asnumpy() for k, p in
                net.collect_params().items()})
    return net, model


def _batch(seed, B=3, S=7, T=6):
    rs = np.random.RandomState(seed)
    return (rs.randint(3, V, (B, S)).astype(np.float32),
            rs.randint(3, V, (B, T)).astype(np.float32),
            rs.randint(3, V, (B, T)).astype(np.float32))


def _nd(x):
    return NDArray(torch.as_tensor(x), cpu())


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_and_gradients_match_jax(impl):
    net, model = _pair(impl)
    src, tgt, lab = _batch(1)
    lab[0, -2:] = -1                              # ignored positions
    jloss_fn = jtfm.LabelSmoothedCELoss(0.1)
    with jautograd.record():
        jout = net(nd.array(src), nd.array(tgt))
        jloss = jloss_fn(jout, nd.array(lab))
    jloss.backward()
    loss_fn = tfm.LabelSmoothedCELoss(0.1)
    with autograd.record():
        out = model(_nd(src), _nd(tgt))
        loss = loss_fn(out, _nd(lab))
    loss.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(loss.asnumpy(), jloss.asnumpy(), rtol=2e-4,
                               atol=2e-5)
    jgrads = {k.split("_", 1)[1]: p.grad().asnumpy()
              for k, p in net.collect_params().items()}
    for k, p in model.collect_params().items():
        np.testing.assert_allclose(p.grad().asnumpy(),
                                   jgrads[k.split("_", 1)[1]], rtol=2e-3,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("eps,ignore", [(0.0, -1), (0.1, -1), (0.2, 3)])
def test_label_smoothed_ce_matches_jax(eps, ignore):
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 5, 11).astype(np.float32)
    labels = rs.randint(0, 11, (2, 5)).astype(np.float32)
    labels[1, :2] = ignore
    want = jtfm.LabelSmoothedCELoss(eps, ignore_index=ignore)(
        nd.array(logits), nd.array(labels)).asnumpy()
    got = tfm.LabelSmoothedCELoss(eps, ignore_index=ignore)(
        torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    every = tfm.LabelSmoothedCELoss(eps, ignore_index=ignore)(
        torch.as_tensor(logits), torch.full((2, 5), float(ignore)))
    assert float(every) == 0.0                    # denominator at least 1


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_decoder_is_causal(impl):
    """Changing a future target token changes no earlier logit
    (tests/test_model_zoo.py's check)."""
    _, model = _pair(impl, seed=1, max_length=8)
    rs = np.random.RandomState(1)
    src = torch.as_tensor(rs.randint(3, 12, (2, 6)))
    tgt = rs.randint(3, 12, (2, 6))
    tgt2 = tgt.copy()
    tgt2[:, -1] = (tgt2[:, -1] % 9) + 3
    with autograd.predict_mode(), torch.no_grad():
        l1 = model(src, torch.as_tensor(tgt)).numpy()
        l2 = model(src, torch.as_tensor(tgt2)).numpy()
    np.testing.assert_allclose(l1[:, :-1], l2[:, :-1], atol=1e-5)
    assert np.abs(l1[:, -1] - l2[:, -1]).max() > 1e-4


def test_eager_gluon_training_matches_jax():
    """Three steps of the reference's training loop (record, backward,
    Trainer.step) on both packages: losses and every weight within rtol
    2e-4 / atol 2e-5.  SGD with momentum, not Adam: the key bias has a
    zero gradient (softmax ignores a shift of every score), and Adam
    turns each package's rounding noise there into steps of +-lr."""
    net, model = _pair(seed=3)
    src, tgt, lab = _batch(4)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jgluon.Trainer(net.collect_params(), "sgd", dict(opt))
    tr = gluon.Trainer(model.collect_params(), "sgd", dict(opt))
    jloss_fn, loss_fn = jtfm.LabelSmoothedCELoss(), tfm.LabelSmoothedCELoss()
    for _ in range(3):
        with jautograd.record():
            jl = jloss_fn(net(nd.array(src), nd.array(tgt)), nd.array(lab))
        jl.backward()
        jtr.step(3)
        with autograd.record():
            tl = loss_fn(model(_nd(src), _nd(tgt)), _nd(lab))
        tl.backward()
        tr.step(3)
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=2e-4,
                                   atol=2e-5)
    jw = {k.split("_", 1)[1]: p.data().asnumpy()
          for k, p in net.collect_params().items()}
    for k, p in model.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jw[k.split("_", 1)[1]], rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_greedy_decode_and_beam_search_match_jax():
    """Both decoders against JAX's on the same weights (dense), and the
    port's flash model (its plain path here) decodes as its dense one."""
    net, model = _pair(seed=5)
    src = np.random.RandomState(6).randint(3, V, (2, 5)).astype(np.float32)
    want = net.greedy_decode(nd.array(src), bos_id=1, eos_id=2, max_len=6)
    got = model.greedy_decode(src, bos_id=1, eos_id=2, max_len=6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    jt, js = jtfm.beam_search(net, nd.array(src), bos_id=1, eos_id=2,
                              beam_size=3, max_len=5, alpha=0.6)
    tt, ts = tfm.beam_search(model, src, bos_id=1, eos_id=2, beam_size=3,
                             max_len=5, alpha=0.6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    flash = tfm.transformer_tiny(V, V, dropout=0.0, max_length=16,
                                 attention_impl="flash", device=cpu())
    convert.load_transformer_params(flash, convert_params(model))
    np.testing.assert_array_equal(
        flash.greedy_decode(src, bos_id=1, eos_id=2, max_len=6), got)
    ft, fs = tfm.beam_search(flash, src, bos_id=1, eos_id=2, beam_size=3,
                             max_len=5, alpha=0.6)
    np.testing.assert_array_equal(ft, tt)
    np.testing.assert_allclose(fs, ts, rtol=1e-5)


def convert_params(model):
    """A port model's parameters as the numpy dict the loaders take."""
    return {k: p.data().asnumpy() for k, p in model.collect_params().items()}


def test_beam_loop_and_logsumexp_are_the_references():
    """The numpy core, on a scoring function of its own, with EOS."""
    rs = np.random.RandomState(7)
    table = rs.randn(64, 9).astype(np.float32)

    def score(flat):
        return table[(flat.sum(axis=1) * 7 + flat.shape[1]) % 64]

    for kw in ({"init_token": 1, "eos_id": 2},
               {"init_token": None, "eos_id": None,
                "seed_beams": rs.randint(3, 9, (2, 3))}):
        want = jtfm.beam_loop(score, 2, 3, max_steps=5, alpha=0.6, **kw)
        got = tfm.beam_loop(score, 2, 3, max_steps=5, alpha=0.6, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(tfm._logsumexp(table),
                                  jtfm._logsumexp(table))


def test_transformer_base_shapes_and_names():
    """transformer_base's configuration (d_model 512, 6 + 6 layers, 8
    heads, d_ff 2048) by parameter shape, built on the meta device; the
    parameter names are the JAX package's less the top-level prefix."""
    model = tfm.transformer_base(37000, 37000, device="meta")
    params = {k.split("_", 1)[1]: tuple(p.shape)
              for k, p in model.collect_params().items()}
    assert params["src_embed_weight"] == (37000, 512)
    assert params["enc_layer5_ffn1_weight"] == (2048, 512)
    assert params["dec_layer5_cross_qkv_weight"] == (1536, 512)
    assert params["out_weight"] == (37000, 512)
    assert "enc_layer6_qkv_weight" not in params
    jnames = {k.split("_", 1)[1] for k in
              jtfm.transformer_tiny(V, V).collect_params()}
    tnames = {k.split("_", 1)[1] for k in
              tfm.transformer_tiny(V, V, device=cpu()).collect_params()}
    assert jnames == tnames
