"""The port's ResNet path against the JAX package's, on the CPU, with the
same numpy inputs through both and the JAX weights carried across by
``convert.load_gluon_params``: ResNet-50 v1's names, shapes and forward,
the V1/V2 blocks at a small size, three ``ShardedTrainer`` steps on a
small ``BottleneckV1`` ResNet (losses, parameters, BatchNorm's running
statistics), NHWC against NCHW, the deferred-initialisation pass, the
entry point and the bench tool.  Tolerances are ``tests/test_parallel.py``'s:
rtol 2e-4 / atol 2e-5 on outputs and losses, 2e-3 / 2e-4 on gradients and
trained parameters.

The training cases run 4 images of 64x64, so the last stage's BatchNorms
normalise over 16 values a channel.  At 3 images of 32x32 (3 values a
channel at the last stage) f32 rounding alone moves ``conv0_weight``'s
gradient by ~1e-3 in both packages (JAX 1.4e-3, the port 6.3e-4 from an
f64 run of the port), past the gradient tolerance; at 4 x 64x64 both
stay within 6.2e-6 of f64."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, parallel as jparallel
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert, initializer
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel_mesh
from mxnet_tpu_torch.tools import bench_resnet
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
SMALL = ([1, 1, 1, 1], [16, 32, 64, 128, 256])


def _numpy_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _randomize(net, seed):
    """Random BatchNorm scales, shifts and running statistics (positive
    variances), so every parameter matters and inference mode is not the
    identity."""
    rng = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(nd.array(rng.uniform(0.5, 1.5, p.shape)))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(nd.array(rng.uniform(-0.2, 0.2, p.shape)))


def _jax_net(make, x, seed=0):
    """The JAX package's net from ``make``, Xavier-initialised from
    ``seed``, BatchNorm randomised, hybridized.  The deferred shapes come
    from a forward of the port's net on ``x[:1]``; the JAX parameters then
    draw in the order of its own deferred pass (registration order, which
    is forward order in these nets), which spares the JAX net the op-by-op
    first forward that compiles each operator on its own."""
    with cpu():
        src = make(tvision)
        src.initialize()
        with torch.no_grad():
            src(torch.from_numpy(x[:1]))
    shapes = _strip(src)
    mx.random.seed(seed)
    net = make(jvision)
    net.initialize(init=mx.init.Xavier())
    for name, p in net.collect_params().items():
        if p._deferred_init:
            p.shape = shapes[name[len(net.prefix):]]
            p._finish_deferred_init()
    _randomize(net, seed + 1)
    net.hybridize()                  # one compiled program, not op by op
    return net


def _port_net(make, params):
    with cpu():
        net = make(tvision)
        net.initialize()
    convert.load_gluon_params(net, params)
    return net


def _strip(net):
    return {k[len(net.prefix):]: tuple(p.shape)
            for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def resnet50():
    x = np.random.RandomState(0).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)
    jnet = _jax_net(lambda v: v.resnet50_v1(classes=1000), x)
    tnet = _port_net(lambda v: v.resnet50_v1(classes=1000),
                     _numpy_params(jnet))
    return jnet, tnet, x


def test_resnet50_names_shapes_and_count(resnet50):
    jnet, tnet, _ = resnet50
    assert _strip(tnet) == _strip(jnet)
    assert list(_strip(tnet)) == list(_strip(jnet))        # same order
    n_params = sum(int(np.prod(s)) for s in _strip(tnet).values())
    assert 24e6 < n_params < 27e6, n_params
    assert "stage1_conv0_weight" in _strip(tnet)
    assert tnet.prefix.startswith("resnetv1")
    # torch sees the same tensors: trainable ones as parameters, the
    # running statistics as buffers
    n_torch = sum(p.numel() for p in tnet.parameters()) + \
        sum(b.numel() for b in tnet.buffers())
    assert n_torch == n_params
    assert len(list(tnet.buffers())) == 2 * 53


def test_resnet50_forward_matches_jax(resnet50):
    jnet, tnet, x = resnet50
    want = jnet(nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_error_tracks_the_jax_bf16_error(resnet50):
    """bf16 against f32 on the same weights, in predict mode with the drawn
    running statistics, for both packages: the port's bf16 logits stay
    within 0.05 max|f32| of its f32 ones (~0.007 here), and stand about as
    far from them as the JAX package's do from its own (relative L2 ~0.007
    for both).  Predict mode, since in training mode batch statistics
    carry bf16 rounding far past 0.05 in both packages (relative L2 0.33
    at 2 x 64x64), where a ratio of the two errors would say little."""
    import copy

    jnet, tnet, x = resnet50
    jb = copy.deepcopy(jnet)
    jb.cast("bfloat16")
    j32 = jnet(nd.array(x)).asnumpy()
    j16 = jb(nd.array(x).astype("bfloat16")).astype("float32").asnumpy()
    tb = copy.deepcopy(tnet).cast("bfloat16")
    with torch.no_grad():
        t32 = tnet(torch.from_numpy(x)).numpy()
        t16 = tb(torch.from_numpy(x).bfloat16()).float().numpy()
    jmax = np.abs(j16 - j32).max() / np.abs(j32).max()
    tmax = np.abs(t16 - t32).max() / np.abs(t32).max()
    jerr = np.linalg.norm(j16 - j32) / np.linalg.norm(j32)
    terr = np.linalg.norm(t16 - t32) / np.linalg.norm(t32)
    print(f"bf16 against f32, max abs err / max|f32|: JAX {jmax:.4f}, port "
          f"{tmax:.4f}; relative L2: JAX {jerr:.4f}, port {terr:.4f}")
    assert tmax <= 0.05, tmax
    assert terr <= 1.5 * jerr, (terr, jerr)


@pytest.mark.parametrize("version,block,thumbnail", [
    (1, "BasicBlockV1", False),
    (2, "BottleneckV2", False),
    (2, "BasicBlockV2", True),
])
def test_resnet_blocks_match_jax_in_training(version, block, thumbnail):
    """Outputs, the loss, every gradient and the moved running statistics
    of a small ResNet of each block kind, in training mode through the
    NDArray path (record + backward)."""
    channels = [8, 8, 16, 32, 64] if "Basic" in block else \
        [8, 16, 32, 64, 128]

    def make(v):
        cls = v.ResNetV1 if version == 1 else v.ResNetV2
        return cls(getattr(v, block), [1, 1, 1, 1], channels, classes=7,
                   thumbnail=thumbnail)

    rng = np.random.RandomState(version)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 7, 4).astype(np.float32)
    jnet = _jax_net(make, x, seed=version)
    tnet = _port_net(make, _numpy_params(jnet))
    with mx.autograd.record():
        jl = jloss.SoftmaxCrossEntropyLoss()(jnet(nd.array(x)), nd.array(y))
    jl.backward()
    with cpu(), tag.record():
        tl = tloss.SoftmaxCrossEntropyLoss()(tnet(tnd.array(x)),
                                             tnd.array(y))
    tl.backward()
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for (jk, j), (tk, t) in zip(jp.items(), tp.items()):
        if j.grad_req == "null":
            np.testing.assert_allclose(t.data().asnumpy(),
                                       j.data().asnumpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=tk)
        else:
            np.testing.assert_allclose(t.grad().asnumpy(),
                                       j.grad().asnumpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=tk)


def _small(v, layout="NCHW"):
    return v.ResNetV1(v.BottleneckV1, *SMALL, classes=10, layout=layout)


def _f64_kink_scan(seed, accum, lr, eps=1e-7, nudges=16):
    """The largest move of the final parameters and running statistics of
    three f64 ShardedTrainer steps from ``seed``'s point (the data and the
    JAX net's weights ``test_sharded_trainer_matches_jax`` draws) when the
    trained parameters are nudged by ``eps`` times a standard normal.  A
    smooth trajectory moves linearly in ``eps``; a trajectory next to a
    ReLU or max-pool kink jumps, and an f32 run there lands on either side
    by the order of its sums.  Not run by the suite: it picked the seed."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((4 * accum, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 10, 4 * accum).astype(np.float32)
    params = _numpy_params(_jax_net(_small, x, seed=seed))

    def final(nudge):
        net = _port_net(_small, params).cast("float64")
        if nudge is not None:
            g = np.random.RandomState(nudge)
            for p in net.collect_params().values():
                if p.grad_req != "null":
                    p.set_data(p.data()._data + eps * torch.from_numpy(
                        g.standard_normal(p.shape)))
        with cpu():
            tr = ShardedTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                                {"learning_rate": lr, "momentum": 0.9,
                                 "wd": 1e-4}, mesh=data_parallel_mesh(1),
                                grad_accum=accum)
        for _ in range(3):
            tr.step(torch.from_numpy(x).double(), torch.from_numpy(y))
        return [p.data()._data for p in net.collect_params().values()]

    base = final(None)
    return max(float((a - b).abs().max()) for n in range(nudges)
               for a, b in zip(final(n), base))


# The point each case trains from.  Seed 3 put the accum=1, lr 0.1 case
# within 1e-7 of a kink: one of four 1e-7 nudges moved its f64 run by
# 0.0998 (``_f64_kink_scan(3, 1, 0.1, nudges=4)``), and the port's f32 run
# followed the JAX run only under some thread counts.  At seed 52 sixteen
# 1e-7 nudges move it by at most 3.8e-5, linearly (1e-9 nudges: 3.8e-7),
# the smallest of seeds 3-60 in that scan.  With grad_accum=2 each
# microbatch holds 4 of 8 images (16 values a channel at the last stage,
# as with accum=1); at lr 0.1 those steps amplify f32 rounding (the JAX
# step's weights stood up to 6.5e-3 from an f64 run of the port, the
# port's f32 run 8.6e-4), at lr 0.02 both stay within 5.1e-6 of it.
SEEDS = {1: 52, 2: 3}


@pytest.mark.parametrize("accum,lr", [(1, 0.1), (2, 0.02)])
def test_sharded_trainer_matches_jax(accum, lr):
    """Three SGD steps (momentum 0.9, wd 1e-4 on every parameter, BN's
    gamma and beta and the biases included) on a small BottleneckV1
    ResNet: losses, trained parameters and running statistics; with
    grad_accum=2 the statistics take two sequential updates a step."""
    rng = np.random.RandomState(SEEDS[accum])
    x = rng.standard_normal((4 * accum, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 10, 4 * accum).astype(np.float32)
    jnet = _jax_net(_small, x, seed=SEEDS[accum])
    tnet = _port_net(_small, _numpy_params(jnet))
    opt = {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4}
    jtr = jparallel.ShardedTrainer(
        jnet, jloss.SoftmaxCrossEntropyLoss(), "sgd", opt,
        mesh=jparallel.data_parallel_mesh(1), grad_accum=accum)
    with cpu():
        mesh = data_parallel_mesh(1)
    ttr = ShardedTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(), "sgd", opt,
                         mesh=mesh, grad_accum=accum)
    want, got = [], []
    for _ in range(3):
        want.append(float(jtr.step(nd.array(x), nd.array(y)).asnumpy()))
        got.append(float(ttr.step(x, y)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[-1] < got[0]
    jtr.sync_params()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    moved = 0
    for (jk, j), (tk, t) in zip(jp.items(), tp.items()):
        assert jk[len(jnet.prefix):] == tk[len(tnet.prefix):]
        tol = (RTOL, ATOL) if j.grad_req == "null" else \
            (GRAD_RTOL, GRAD_ATOL)
        np.testing.assert_allclose(t.data().asnumpy(), j.data().asnumpy(),
                                   rtol=tol[0], atol=tol[1], err_msg=tk)
        moved += j.grad_req == "null"
    assert moved == 2 * 17           # 17 BatchNorms


def test_nhwc_equals_nchw():
    """The same weights in both layouts: outputs, loss and gradients, in
    training mode, with the NHWC input the NCHW one transposed.  The
    weights draw from a generator of their own: from the package chain
    they changed with whatever ran before in the process, and one draw in
    ~40 put a ReLU or max-pool element within f32 rounding of its kink,
    where an f32 pass in one layout stood 0.05 from an f64 pass while the
    other and both f64 passes agreed to 2e-14.  From seed 0 sixteen 1e-7
    nudges of the f64 weights move every gradient by at most 6.5e-5
    (linearly), and both f32 layouts stand within 8.9e-6 of f64."""
    rng = np.random.RandomState(4)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    with cpu():
        a = _small(tvision)
        a.initialize(init=initializer.Xavier(),
                     generator=torch.Generator().manual_seed(0))
        a(torch.from_numpy(x))
        b = _small(tvision, "NHWC")
        b.initialize()
    convert.load_gluon_params(b, _numpy_params(a))
    outs, grads = [], []
    for net, inp in ((a, x), (b, x.transpose(0, 2, 3, 1))):
        with tag.train_mode():
            out = net(torch.from_numpy(np.ascontiguousarray(inp)))
            loss = tloss.SoftmaxCrossEntropyLoss()(
                out, torch.from_numpy(y)).mean()
        params = [p._value() for p in net.collect_params().values()
                  if p.grad_req != "null"]
        grads.append(torch.autograd.grad(loss, params))
        outs.append(out.detach().numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    for g1, g0 in zip(*grads):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_deferred_init_pass_leaves_running_stats():
    """The trainer's first step materialises the deferred parameters with
    one forward in predict mode: the running statistics are still the
    initial zeros and ones after it, and move only in the step itself."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    y = rng.randint(0, 10, 2).astype(np.float32)
    with cpu():
        net = _small(tvision)
        net.initialize(init=initializer.Xavier())
        mesh = data_parallel_mesh(1)
    params = net.collect_params()
    assert any(p._deferred_init for p in params.values())
    tr = ShardedTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1}, mesh=mesh)
    tr._stage(x)
    assert not any(p._deferred_init for p in params.values())
    for name, p in params.items():
        if name.endswith("running_mean"):
            assert not p.data().asnumpy().any(), name
        elif name.endswith("running_var"):
            assert (p.data().asnumpy() == 1).all(), name
    tr.step(x, y)
    assert params[net.prefix + "batchnorm0_running_mean"] \
        .data().asnumpy().any()


def test_entry_runs_on_the_cpu_when_asked():
    from mxnet_tpu_torch.entry import entry

    with cpu():
        fn, (example,) = entry()
    assert example.shape == (8, 3, 224, 224) and example.device.type == "cpu"
    with torch.no_grad():
        out = fn(example[:2])
    assert out.shape == (2, 1000) and bool(torch.isfinite(out).all())


def test_get_model_builds_every_resnet_name(tmp_path):
    from mxnet_tpu_torch.base import MXNetError

    for name in ("resnet18_v1", "resnet50_v2", "resnet152_v1"):
        with cpu():
            net = tvision.get_model(name, classes=10)
        assert isinstance(net, (tvision.ResNetV1, tvision.ResNetV2))
    with pytest.raises(ValueError, match="not supported"):
        tvision.get_model("resnet19_v1")
    # pretrained weights come from a local file only: none here
    with pytest.raises(MXNetError, match="not found"):
        tvision.resnet18_v1(pretrained=True, root=str(tmp_path))


def test_bench_tool_runs_on_the_cpu(monkeypatch):
    """bench_resnet's path and result line on the CPU, with the small
    BottleneckV1 ResNet (1000 classes) in ResNet-50's place, as
    bench_bert's host test swaps in bert_tiny: ResNet-50 itself is held
    against the JAX model above and trained by the bench on the card."""
    monkeypatch.setattr(
        bench_resnet.vision, "resnet50_v1",
        lambda classes, layout: tvision.ResNetV1(
            tvision.BottleneckV1, *SMALL, classes=classes, layout=layout))
    res = bench_resnet.run(batch=2, image=32, steps=1, device=cpu())
    assert res["metric"] == "resnet50_train_samples_per_sec_per_chip"
    assert res["dtype"] == "bfloat16" and res["layout"] == "NCHW"
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["mfu"] is None and res["peak_mem_gib"] is None
    assert res["flops_per_step"] == pytest.approx(
        2 * 3 * 2 * 4.089e9 * (32 / 224) ** 2)
    trainer, x, y = bench_resnet.build(batch=2, image=32, layout="NHWC",
                                       device=cpu())
    assert tuple(x.shape) == (2, 32, 32, 3) and x.dtype == torch.bfloat16
    assert y.dtype == torch.float32
    trainer.step(x, y)
    for p in trainer.block.collect_params().values():
        assert p.data()._data.dtype == torch.bfloat16, p.name
