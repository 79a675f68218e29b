"""The port's BERT pretraining path against the JAX package's, on the CPU,
at ``bert_tiny`` (units 64, 2 layers, 4 heads, D = 16, vocab 1024) and
T = 32, with the same numpy inputs through both and the JAX weights
carried across by ``convert.load_bert_params``.  JAX flash attention runs
its Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU.  Also: the ported initializers (scales, moments and the
per-parameter dispatch), the one-device mesh, and the bench tool."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd, nd, parallel as jparallel
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu_torch import convert, initializer
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.parallel import (ShardedTrainer, data_parallel_mesh,
                                      make_mesh, mesh_axis_size)
from mxnet_tpu_torch.tools import bench_bert

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
B, T, VOCAB = 2, 32, 1024
OUTPUTS = ("seq", "pooled", "nsp_logits", "mlm_logits")


def _jax_bert(impl, scan=True, seed=0):
    """bert_tiny with Xavier weights and random (not zero/one) biases and
    LayerNorm parameters, so every parameter trains."""
    mx.random.seed(seed)
    net = jbert.bert_tiny(scan_layers=scan, attention_impl=impl,
                          dropout=0.0)
    net.initialize(init=mx.init.Xavier())
    rng = np.random.RandomState(seed + 1)
    for name, p in net.collect_params().items():
        if name.endswith(("bias", "beta", "gamma")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(nd.array(
                base + 0.1 * rng.randn(*p.shape).astype(np.float32)))
    return net


def _params(net):
    return {n: p.data().asnumpy().astype(np.float32)
            for n, p in net.collect_params().items()}


def _port_of(net, impl):
    """The port's bert_tiny in the JAX net's trunk layout, its weights
    loaded by name."""
    params = _params(net)
    scan = any(k.endswith("qkv_stack_weight") for k in params)
    model = tbert.bert_tiny(attention_impl=impl, dropout=0.0,
                            scan_layers=scan, device=cpu())
    convert.load_bert_params(model, params)
    return model


def _batch(seed=0):
    """bench_bert's data at the test size: tokens, 15% MLM labels (-1
    elsewhere), NSP labels, and token types."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, VOCAB, (B, T))
    mlm = np.full((B, T), -1, np.int64)
    mask = rng.rand(B, T) < 0.15
    mlm[mask] = rng.randint(0, VOCAB, int(mask.sum()))
    nsp = rng.randint(0, 2, (B,))
    types = (np.arange(T)[None, :] >= rng.randint(1, T, (B, 1))).astype(
        np.int64)
    return tokens, mlm, nsp, types


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bert_outputs_match_jax(impl, with_types):
    net = _jax_bert(impl)
    model = _port_of(net, impl)
    tokens, _, _, types = _batch()
    jargs = (nd.array(tokens.astype(np.float32)),)
    targs = (torch.from_numpy(tokens),)
    if with_types:
        jargs += (nd.array(types.astype(np.float32)),)
        targs += (torch.from_numpy(types),)
    want = net(*jargs)
    got = model(*targs)
    assert len(got) == 4 and not model.training
    for name, a, b in zip(OUTPUTS, got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close(a, b.asnumpy(), what=name)


def test_scan_false_model_loads_through_the_per_layer_route():
    net = _jax_bert("dense", scan=False)
    assert any("enc_layer1_qkv_weight" in n for n in net.collect_params())
    model = _port_of(net, "dense")
    tokens = _batch()[0]
    want = net(nd.array(tokens.astype(np.float32)))
    got = model(torch.from_numpy(tokens))
    for name, a, b in zip(OUTPUTS, got, want):
        _close(a, b.asnumpy(), what=name)


def test_heads_follow_the_reference_without_a_pooler():
    """use_pooler=False, use_classifier=True: the reference still builds
    the NSP classifier, so its nsp_* entries load, and the outputs are
    (seq, mlm_logits) as the reference's."""
    mx.random.seed(0)
    net = jbert.bert_tiny(scan_layers=True, dropout=0.0, use_pooler=False)
    net.initialize(init=mx.init.Xavier())
    assert any(n.endswith("nsp_weight") for n in net.collect_params())
    model = tbert.bert_tiny(dropout=0.0, use_pooler=False, device=cpu())
    convert.load_bert_params(model, _params(net))
    tokens = _batch()[0]
    want = net(nd.array(tokens.astype(np.float32)))
    got = model(torch.from_numpy(tokens))
    assert len(got) == len(want) == 2
    for name, a, b in zip(("seq", "mlm_logits"), got, want):
        _close(a, b.asnumpy(), what=name)


@pytest.mark.parametrize("lora", [{"lora_rank": 4}, {"lora_alpha": 8.0}])
def test_lora_options_are_refused(lora):
    """The LoRA options build the JAX package's model: with a rank, the
    trunk's qkv_lora_a/b stacks (B made non-zero here, so the adapted
    qkv weight differs from the base) give the JAX outputs; an alpha
    without a rank adds nothing, as there."""
    mx.random.seed(0)
    net = jbert.bert_tiny(scan_layers=True, dropout=0.0, **lora)
    net.initialize(init=mx.init.Xavier())
    rng = np.random.RandomState(5)
    for name, p in net.collect_params().items():
        if "lora" in name:
            p.set_data(nd.array(0.1 * rng.randn(*p.shape).astype(
                np.float32)))
    model = tbert.bert_tiny(device=cpu(), scan_layers=True, dropout=0.0,
                            **lora)
    assert sorted(model.collect_params()) == sorted(
        k.replace(net.prefix, model.prefix, 1)
        for k in net.collect_params())
    assert any("lora" in k for k in model.collect_params()) == \
        ("lora_rank" in lora)
    convert.load_bert_params(model, _params(net))
    tokens = _batch()[0]
    want = net(nd.array(tokens.astype(np.float32)))
    got = model(torch.from_numpy(tokens))
    for name, a, b in zip(OUTPUTS, got, want):
        _close(a, b.asnumpy(), what=name)
    if "lora_rank" in lora:
        with pytest.raises(ValueError, match="scan_layers=True"):
            tbert.bert_tiny(device=cpu(), **lora)


def test_load_bert_params_checks_before_copying():
    net = _jax_bert("dense")
    params = _params(net)
    model = tbert.bert_tiny(device=cpu())
    before = {n: p.clone() for n, p in model.named_parameters()}
    prefix = next(k for k in params
                  if k.endswith("word_embed_weight"))[:-len("word_embed_"
                                                            "weight")]
    bad_shape = dict(params)
    bad_shape[prefix + "nsp_weight"] = np.zeros((3, 64), np.float32)
    missing = {k: v for k, v in params.items() if "pooler_bias" not in k}
    extra = dict(params, **{prefix + "extra_weight": np.zeros(3)})
    twice = dict(params, **{"other_word_embed_weight": np.zeros(3)})
    for bad, match in ((bad_shape, "shape"), (missing, "pooler_bias"),
                       (extra, "extra_weight"), (twice, "word_embed")):
        with pytest.raises(MXNetError, match=match):
            convert.load_bert_params(model, bad)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("float_labels", [False, True])
def test_pretrain_loss_and_gradients_match_jax(float_labels):
    rng = np.random.RandomState(3)
    nsp_logits = rng.randn(B, 2).astype(np.float32) * 2
    mlm_logits = rng.randn(B, T, 50).astype(np.float32) * 3
    mlm = rng.randint(0, 50, (B, T))
    mlm[rng.rand(B, T) < 0.7] = -1
    nsp = rng.randint(0, 2, (B,))
    if float_labels:            # the JAX examples feed float labels
        mlm, nsp = mlm.astype(np.float32), nsp.astype(np.float32)
    want, (wn, wm) = jax.value_and_grad(
        lambda a, b: jbert._bert_pretrain_loss_pure(
            a, b, jnp.asarray(mlm), jnp.asarray(nsp)), argnums=(0, 1))(
        jnp.asarray(nsp_logits), jnp.asarray(mlm_logits))
    tn = torch.from_numpy(nsp_logits).requires_grad_()
    tm = torch.from_numpy(mlm_logits).requires_grad_()
    got = tbert.BERTPretrainLoss()(
        (None, None, tn, tm), (torch.from_numpy(mlm), torch.from_numpy(nsp)))
    gn, gm = torch.autograd.grad(got, (tn, tm))
    assert got.dim() == 0 and got.dtype == torch.float32
    _close(got, want)
    _close(gn, wn, GRAD_RTOL, GRAD_ATOL)
    _close(gm, wm, GRAD_RTOL, GRAD_ATOL)
    # the MLM half alone is BERTMLMLoss
    _close(tbert.BERTMLMLoss()(torch.from_numpy(mlm_logits),
                               torch.from_numpy(mlm)),
           jbert.masked_token_ce(jnp.asarray(mlm_logits), jnp.asarray(mlm)))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_model_gradients_match_jax(impl):
    """Every parameter's gradient of the pretraining loss, the tied
    word_embed_weight (the gather and the decode) among them."""
    net = _jax_bert(impl)
    model = _port_of(net, impl)
    tokens, mlm, nsp, _ = _batch(1)
    params = net.collect_params()
    with jautograd.record():
        loss = jbert.BERTPretrainLoss()(
            net(nd.array(tokens.astype(np.float32))),
            (nd.array(mlm.astype(np.float32)),
             nd.array(nsp.astype(np.float32))))
    loss.backward()
    want = {n: p.grad().asnumpy() for n, p in params.items()}
    got_loss = tbert.BERTPretrainLoss()(
        model(torch.from_numpy(tokens)),
        (torch.from_numpy(mlm), torch.from_numpy(nsp)))
    _close(got_loss, loss.asnumpy())
    names, ps = zip(*((n, p._value())
                      for n, p in model.collect_params().items()))
    grads = dict(zip(names, torch.autograd.grad(got_loss, ps)))
    for name, g in grads.items():
        key = net.prefix + name[len(model.prefix):]
        _close(g, want[key], GRAD_RTOL, GRAD_ATOL, what=name)
    assert float(grads[model.prefix + "word_embed_weight"].abs().max()) > 0


@pytest.mark.parametrize("impl,accum", [("dense", 1), ("flash", 1),
                                        ("dense", 2)])
def test_sharded_trainer_matches_jax(impl, accum):
    """Five adamw steps through both ShardedTrainers, each given a
    one-device mesh: the loss trajectory at rtol 2e-4, the final
    parameters at 2e-3 / 2e-4.  With grad_accum=2 the tuple labels are
    split into microbatches as the tokens are."""
    net = _jax_bert(impl)
    model = _port_of(net, impl)
    tokens, mlm, nsp, _ = _batch(2)
    params = {"learning_rate": 1e-3, "wd": 1e-2}
    jtr = jparallel.ShardedTrainer(net, jbert.BERTPretrainLoss(), "adamw",
                                   params,
                                   mesh=jparallel.data_parallel_mesh(1),
                                   grad_accum=accum)
    with cpu():
        mesh = data_parallel_mesh(1)
    ttr = ShardedTrainer(model, tbert.BERTPretrainLoss(), "adamw", params,
                         mesh=mesh, grad_accum=accum)
    jx = nd.array(tokens.astype(np.float32))
    jy = (nd.array(mlm.astype(np.float32)), nd.array(nsp.astype(np.float32)))
    want, got = [], []
    for _ in range(5):
        want.append(float(np.asarray(jtr.step(jx, jy)._data)))
        got.append(float(ttr.step(tokens, (mlm, nsp))))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0] and not model.training
    jtr.sync_params()
    ref = _port_of(net, impl)          # the JAX-trained weights, in the port
    for (name, a), b in zip(model.named_parameters(), ref.parameters()):
        _close(a, b.detach().numpy(), GRAD_RTOL, GRAD_ATOL, what=name)


def test_bf16_forward_matches_jax():
    """Both models cast to bf16: each output within 0.05 * max|ref| of
    the JAX one, the tolerance of tests/test_model_zoo.py's bf16 decoder."""
    net = _jax_bert("flash")
    model = _port_of(net, "flash")
    net.cast("bfloat16")
    model.cast("bfloat16")
    tokens = _batch()[0]
    want = net(nd.array(tokens.astype(np.float32)))
    got = model(torch.from_numpy(tokens))
    for name, a, b in zip(OUTPUTS, got, want):
        assert a.dtype == torch.bfloat16, name
        ref = np.asarray(b.asnumpy(), np.float32)
        _close(a, ref, 0.0, 0.05 * np.abs(ref).max(), what=name)


class _Matmuls(TorchFunctionMode):
    """Records the operand dtypes and shapes of every matrix product."""

    FNS = {torch.matmul, torch.mm, torch.bmm, torch.addmm, torch.einsum,
           torch.nn.functional.linear, torch.Tensor.matmul,
           torch.Tensor.__matmul__}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.FNS:
            self.seen.append([(a.dtype, a.dim()) for a in args
                              if isinstance(a, torch.Tensor)])
        return func(*args, **(kwargs or {}))


def _weight_products(seen):
    """The products that take a weight: the attention products, on
    (B, H, T, D) operands, run in f32 in both packages."""
    return [ops for ops in seen if not all(d == 4 for _, d in ops)]


def test_bf16_bert_forward_multiplies_in_bf16():
    """The per-layer trunk's (the default layout's) qkv, projection and
    FFN products and the heads' pooler, NSP, transform and tied decode
    all receive bf16 operands."""
    model = tbert.bert_tiny(attention_impl="flash", device=cpu())
    assert isinstance(model.encoder, tbert.TransformerEncoder)
    model.cast("bfloat16")
    with _Matmuls() as rec:
        model(torch.from_numpy(_batch()[0]))
    products = _weight_products(rec.seen)
    assert len(products) == 4 * 2 + 4, rec.seen
    for ops in products:
        assert [dt for dt, _ in ops] == [torch.bfloat16] * 2, ops


def test_bf16_scanned_bert_forward_multiplies_in_bf16():
    """The same with the scanned trunk (scan_layers=True), LoRA stacks
    included: the adapted qkv weight is cast back to bf16 before its
    product."""
    for kw in ({}, {"lora_rank": 4}):
        model = tbert.bert_tiny(attention_impl="flash", scan_layers=True,
                                device=cpu(), **kw)
        model.cast("bfloat16")
        with _Matmuls() as rec:
            model(torch.from_numpy(_batch()[0]))
        products = [ops for ops in _weight_products(rec.seen)
                    if all(dt == torch.bfloat16 for dt, _ in ops)]
        assert len(products) == 4 * 2 + 4, rec.seen
        lora = [ops for ops in _weight_products(rec.seen)
                if ops not in products]
        # the rank-4 product B @ A runs in f32, as the JAX op's
        assert all(dt == torch.float32 for ops in lora for dt, _ in ops)
        assert len(lora) == (2 if kw else 0)


# -- the initializers --------------------------------------------------------


def _xavier_formula(shape, magnitude=3.0):
    """mxnet_tpu/initializer.py's Xavier bound (uniform, avg): fans from
    shape[0], shape[1] and prod(shape[2:])."""
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    return np.sqrt(magnitude / ((shape[1] * hw + shape[0] * hw) / 2.0))


def test_xavier_scale_is_the_reference_formula():
    """Every BERT weight shape, base and tiny, the stacked 3-D trunk
    weights included (their L counts as fan-out: a small scale)."""
    x = initializer.Xavier()
    shapes = set()
    for units, layers, hidden, vocab in ((64, 2, 128, 1024),
                                         (768, 12, 3072, 30522)):
        shapes |= {(layers, 3 * units, units), (layers, units, units),
                   (layers, hidden, units), (layers, units, hidden),
                   (units, units), (2, units), (vocab, units)}
    for shape in sorted(shapes):
        assert x.scale("w", shape) == pytest.approx(_xavier_formula(shape),
                                                    rel=1e-12), shape
    assert initializer.Xavier(factor_type="in").scale("w", (4, 6, 5)) == \
        pytest.approx(np.sqrt(3 / 30))
    with pytest.raises(ValueError, match="at least 2D"):
        x.scale("b", (5,))


def _moments_hold(w, kind, scale):
    """max|w|, mean and variance of a draw within what U(-scale, scale) or
    N(0, scale) allow: the mean within 5 standard errors, the variance
    within 5 standard errors of its estimate."""
    w = w.detach().double().flatten()
    n = w.numel()
    var = scale ** 2 / 3 if kind == "uniform" else scale ** 2
    kurt = 1.8 if kind == "uniform" else 3.0         # E[x^4] / var^2
    if kind == "uniform":
        assert float(w.abs().max()) <= scale
        assert float(w.abs().max()) > scale * (1 - 20.0 / n)
    assert abs(float(w.mean())) <= 5 * np.sqrt(var / n)
    assert abs(float(w.var()) - var) <= 5 * var * np.sqrt((kurt - 1) / n)


def test_initializer_draws_hold_their_moments():
    g = torch.Generator().manual_seed(0)
    for init, kind, scale in ((initializer.Uniform(), "uniform", 0.07),
                              (initializer.Normal(), "normal", 0.01),
                              (initializer.create("normal", sigma=0.3),
                               "normal", 0.3)):
        w = torch.empty(256, 300)
        init("w_weight", w, g)
        _moments_hold(w, kind, scale)
    model = tbert.bert_tiny(device=cpu())
    model.initialize(initializer.Xavier(),
                     generator=torch.Generator().manual_seed(1))
    for name, p in model.named_parameters():
        if name.endswith("embed_weight"):
            _moments_hold(p, "normal", 0.01)
        elif name.endswith("weight"):
            _moments_hold(p, "uniform", _xavier_formula(tuple(p.shape)))
    # bf16 parameters take the f32 draw rounded
    w = torch.empty(64, 64, dtype=torch.bfloat16)
    initializer.Xavier()("w_weight", w, torch.Generator().manual_seed(2))
    assert w.dtype == torch.bfloat16 and float(w.float().abs().max()) > 0
    with pytest.raises(ValueError, match="Unknown initialization"):
        initializer.Xavier()("w_scale", w)
    with pytest.raises(ValueError, match="no parameter named"):
        initializer.initialize(model, "xavier", {"nope": "zeros"})


def _kind(arr, shape):
    a = np.asarray(arr, np.float64)
    if not a.any():
        return "zeros"
    if (a == 1).all():
        return "ones"
    s = _xavier_formula(shape) if len(shape) >= 2 else None
    if s is not None and np.abs(a).max() <= s * (1 + 1e-6) and \
            abs(a.std() / (s / np.sqrt(3)) - 1) < 0.25:
        return "xavier"
    if abs(a.std() / 0.01 - 1) < 0.25:
        return "normal(0.01)"
    return "other"


def test_initialize_dispatch_matches_jax():
    """For every BERT parameter name, the port's initialize makes the JAX
    package's choice: Xavier on weights, its own init where the parameter
    has one (normal on the embedding tables, zeros on decoder_bias and
    the biases, ones on LayerNorm scales), the suffix rule elsewhere."""
    mx.random.seed(4)
    net = jbert.bert_tiny(scan_layers=True, dropout=0.0)
    net.initialize(init=mx.init.Xavier())
    want = _params(net)
    model = tbert.bert_tiny(device=cpu(), scan_layers=True)
    model.initialize(initializer.Xavier(),
                     generator=torch.Generator().manual_seed(4))
    kinds = {}
    for name, p in model.collect_params().items():
        key = net.prefix + name[len(model.prefix):]
        mine = _kind(p.data().asnumpy(), tuple(p.shape))
        assert mine == _kind(want[key], want[key].shape), (name, key)
        kinds[mine] = kinds.get(mine, 0) + 1
    assert kinds == {"xavier": 7, "normal(0.01)": 3, "zeros": 13,
                     "ones": 5}, kinds


# -- the mesh ----------------------------------------------------------------


def test_mesh_shapes_and_refusals():
    devs = [torch.device("cpu")] * 8
    mesh = make_mesh(dp=2, tp=2, pp=2, devices=devs)
    assert mesh.shape == {"pp": 2, "dp": 2, "tp": 2}
    assert mesh.axis_names == ("pp", "dp", "tp") and mesh.size == 8
    assert mesh_axis_size(mesh, "tp") == 2
    assert mesh_axis_size(mesh, "sp") == 1
    assert make_mesh(devices=devs[:1]).shape == {"dp": 1}
    with pytest.raises(ValueError, match="only 1 available"):
        make_mesh(dp=2, devices=devs[:1])
    with pytest.raises(ValueError, match="positive int"):
        make_mesh(dp=0, devices=devs)
    with cpu():
        one = data_parallel_mesh(1)
        assert one.shape == {"dp": 1}
        assert list(one.devices.flat) == [torch.device("cpu")]
        assert data_parallel_mesh().size == 1
    if not torch.cuda.is_available():
        # outside a CPU scope the mesh is over the visible CUDA cards
        with pytest.raises(ValueError, match="only 0 available"):
            data_parallel_mesh(1)
    model = tbert.bert_tiny(device=cpu())
    loss = tbert.BERTPretrainLoss()
    for kwargs in ({"mesh": make_mesh(dp=2, devices=devs)},
                   {"mesh": object()}, {"mesh": one, "rules": object()},
                   {"mesh": one, "mode": "fsdp"}):
        with pytest.raises(NotImplementedError):
            ShardedTrainer(model, loss, "adamw", **kwargs)
    tokens, mlm, nsp, _ = _batch()
    wrong = ShardedTrainer(model, loss, "adamw",
                           mesh=make_mesh(devices=[torch.device("meta")]))
    with pytest.raises(MXNetError, match="the mesh holds meta"):
        wrong.step(tokens, (mlm, nsp))


def test_bench_tool_on_the_host(monkeypatch):
    """bench_bert.run's path and result line on the CPU, with bert_tiny in
    bert_base's place: the bench's data (15% MLM labels), a falling loss,
    the JSON fields."""
    tokens, mlm, nsp = bench_bert.make_data(4, 64, 30522, "cpu")
    assert tokens.dtype == torch.int64 and int(tokens.max()) < 30000
    share = float((mlm >= 0).float().mean())
    assert 0.08 < share < 0.22 and set(nsp.tolist()) <= {0, 1}
    assert bench_bert.flops_per_step(32, 512) == pytest.approx(
        3 * (2 * 110e6 + 12 * 2 * 2 * 512 * 768) * 32 * 512)
    monkeypatch.setattr(bench_bert.bert, "bert_base", tbert.bert_tiny)
    res = bench_bert.run(batch=2, seq=32, steps=2, device=cpu())
    assert res["metric"] == "bert_base_pretrain_tokens_per_sec_per_chip"
    assert res["impl"] == "torch" and res["mfu"] is None
    assert res["bf16_reduced_precision_reduction"] is (
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    assert len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0] and res["value"] > 0
    # weights and data from one seed: a second run starts from the same step
    again = bench_bert.run(batch=2, seq=32, steps=2, device=cpu())
    assert again["losses"] == res["losses"]


@pytest.mark.parametrize("name, seconds, want", [
    ("NVIDIA H100 80GB HBM3", 1.0, 1e14 / 989e12),
    ("NVIDIA A100-SXM4-80GB", 1.0, None),
    (None, 1.0, None),
    ("NVIDIA H100 80GB HBM3", 0.1, "raises"),
])
def test_bench_mfu_gate(name, seconds, want):
    """MFU is counted against the H100's bf16 peak, null on another card
    or the host, and a reading above MFU_GATE (a clock that stopped before
    the card finished) raises rather than being reported."""
    if want == "raises":
        with pytest.raises(RuntimeError, match="MFU 1.011 above 0.7"):
            bench_bert.mfu(1e14, seconds, name)
    else:
        assert bench_bert.mfu(1e14, seconds, name) == pytest.approx(want)
