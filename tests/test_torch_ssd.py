"""The port's SSD path against the JAX package's, on the CPU: the compact
``SSD(num_classes=2)`` at 64x64, B=2 (its outputs, ``SSDTrainLoss`` and
every gradient, one ``gluon.Trainer`` step), ``ssd_detect``, and
``ImageDetIter`` batches from one seeded ``.rec`` through the detection
augmenters; then ``tools/bench_ssd`` at a toy size.  The JAX weights
carry across through ``convert.load_gluon_params``.

Tolerances: an op's outputs and the loss rtol 1e-4 / atol 1e-5,
gradients and trained parameters rtol 2e-3 / atol 2e-4
(``tests/test_torch_operator.py``); the network's outputs, three
convolutions and training-mode BatchNorms deep, rtol 2e-4 / atol 2e-5,
the model tolerance of ROADMAP and ``tests/test_torch_resnet.py`` (the
two packages' convolutions sum in other orders: 1.8e-5 apart at most
here).  Integer results (the detections' ids, the labels) must be
equal.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.gluon import model_zoo as jzoo
from mxnet_tpu.ops import contrib_det as jdet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon import model_zoo as tzoo
from mxnet_tpu_torch.tools import bench_ssd
from torch_one_thread import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
NET_TOL = dict(rtol=2e-4, atol=2e-5)


def _data(seed=0, B=2, size=64):
    rng = np.random.RandomState(seed)
    x, y = bench_ssd.synthetic_batch(rng, B, size, num_classes=2,
                                     max_objects=3, max_boxes=3)
    return x, y


def _jax_ssd(shapes, params=None):
    """The JAX compact SSD, hybridized, its deferred shapes from
    ``shapes`` (which spares it the op-by-op first pass): Xavier from a
    seed, or ``params``."""
    mx.random.seed(3)
    jnet = jzoo.SSD(num_classes=2)
    jnet.initialize(init=mx.init.Xavier())
    for name, p in jnet.collect_params().items():
        if p._deferred_init:
            p.shape = shapes[name[len(jnet.prefix):]]
            p._finish_deferred_init()
    if params is not None:
        for name, p in jnet.collect_params().items():
            p.set_data(nd.array(params[name[len(jnet.prefix):]]))
    jnet.hybridize()
    return jnet


def _port_ssd(params):
    with cpu():
        tnet = tzoo.SSD(num_classes=2)
        tnet.initialize()
    convert.load_gluon_params(tnet, params)
    return tnet


@pytest.fixture(scope="module")
def nets():
    """The JAX compact SSD and the port's with its weights; the shapes
    and weights (names without the top-level prefix)."""
    x, _ = _data()
    with cpu():
        src = tzoo.SSD(num_classes=2)
        src.initialize()
        with torch.no_grad():
            src(torch.from_numpy(x[:1]))
    shapes = {k[len(src.prefix):]: tuple(p.shape)
              for k, p in src.collect_params().items()}
    jnet = _jax_ssd(shapes)
    params = {k[len(jnet.prefix):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    return jnet, _port_ssd(params), shapes, params


def test_ssd_names_and_forward_match_jax(nets):
    jnet, tnet, _, _ = nets
    strip = lambda n: {k[len(n.prefix):] for k in n.collect_params()}
    assert strip(tnet) == strip(jnet)
    x, _ = _data()
    with jag.record():                         # training-mode BatchNorm
        want = [o.asnumpy() for o in jnet(nd.array(x))]
    with cpu(), tag.record():
        got = [o.asnumpy() for o in tnet(tnd.array(x))]
    N = 3 * (32 * 32 + 16 * 16 + 8 * 8)
    assert [g.shape for g in got] == [(2, 3, N), (2, N * 4), (1, N, 4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **NET_TOL)


class _JaxNetLoss(jgluon.HybridBlock):
    """The JAX net and its SSDTrainLoss as one hybridized program, so the
    reference's loss is not dispatched and differentiated op by op."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss = jzoo.SSDTrainLoss(negative_mining_ratio=3)

    def hybrid_forward(self, F, x, y):
        return self.loss(self.net(x), y)


def _step(pkg, net, x, y, trainer=None):
    """The loss and every gradient of one SSDTrainLoss pass; a trainer
    step after it when given."""
    if pkg is mx:
        fwd = _JaxNetLoss(net)
        fwd.hybridize()
    else:
        loss_fn = pkg.gluon.model_zoo.SSDTrainLoss(negative_mining_ratio=3)
        fwd = lambda a, b: loss_fn(net(a), b)      # noqa: E731
    with pkg.autograd.record():
        loss = fwd(pkg.nd.array(x), pkg.nd.array(y))
    loss.backward()
    grads = {k[len(net.prefix):]: p.grad().asnumpy()
             for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    if trainer is not None:
        trainer.step(x.shape[0])
    return float(loss.asnumpy()), grads


def test_ssd_train_loss_gradients_and_trainer_step_match_jax(nets):
    """The loss (MultiBoxTarget with 3:1 mining, cross-entropy,
    smooth-L1), the gradient of every parameter, then the parameters and
    running statistics after one SGD step (momentum, weight decay)."""
    _, _, shapes, params = nets
    x, y = _data(seed=1)
    tnet = _port_ssd(params)
    jcopy = _jax_ssd(shapes, params)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 5e-4}
    jtr = jgluon.Trainer(jcopy.collect_params(), "sgd", dict(opt))
    with cpu():
        ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    jl, jg = _step(mx, jcopy, x, y, jtr)
    with cpu():
        tl, tg = _step(tmx, tnet, x, y, ttr)
    np.testing.assert_allclose(tl, jl, **FWD_TOL)
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)
    for (k, jp), tp in zip(jcopy.collect_params().items(),
                           tnet.collect_params().values()):
        np.testing.assert_allclose(tp.data().asnumpy(), jp.data().asnumpy(),
                                   err_msg=k, **GRAD_TOL)


def test_ssd_train_loss_targets_carry_no_gradient():
    """The class scores reach the targets only through the mining rank:
    the loss's gradient with respect to them is the cross-entropy's alone,
    whatever the mining picks."""
    rng = np.random.RandomState(5)
    anchors = tmx.ops.contrib_det.multibox_prior(
        torch.zeros(1, 1, 4, 4), sizes=(0.4,), ratios=(1, 2))
    N = anchors.shape[1]
    cls = torch.tensor(rng.standard_normal((2, 3, N)).astype(np.float32),
                       requires_grad=True)
    loc = torch.tensor(rng.standard_normal((2, N * 4)).astype(np.float32),
                       requires_grad=True)
    lab = torch.tensor([[[0, .1, .1, .5, .5]], [[1, .4, .3, .9, .8]]])
    loss = tzoo.ssd.ssd_loss(cls, loc, anchors, lab)
    loss.backward()
    _, _, cls_t = tmx.ops.contrib_det.multibox_target(
        anchors, lab, torch.softmax(cls.detach(), 1), negative_mining_ratio=3)
    assert not cls_t.requires_grad
    valid = cls_t >= 0
    want = torch.softmax(cls.detach(), 1) - torch.nn.functional.one_hot(
        cls_t.clamp(min=0).long(), 3).permute(0, 2, 1)
    want = want * valid[:, None] / valid.sum()
    np.testing.assert_allclose(cls.grad.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_ssd_detect_matches_multibox_detection(nets):
    """``ssd_detect``: the forward (held to the JAX net's above), a softmax
    over the classes, then ``MultiBoxDetection`` at nms_topk 400: its rows
    equal the JAX op's on the port's scores."""
    tnet = nets[1]
    x, _ = _data(seed=2)
    with cpu():
        det = tzoo.ssd_detect(tnet, tnd.array(x)).asnumpy()
        cls, loc, anc = (o.asnumpy() for o in tnet(tnd.array(x)))
    prob = torch.softmax(torch.from_numpy(cls), 1).numpy()
    want = np.asarray(jax.jit(functools.partial(
        jdet.multibox_detection, nms_threshold=0.45, threshold=0.01,
        nms_topk=400))(prob, loc, anc))
    assert det.shape == want.shape == (2, cls.shape[2], 6)
    np.testing.assert_array_equal(det[:, :, 0], want[:, :, 0])
    np.testing.assert_allclose(det, want, **FWD_TOL)
    assert 0 < (det[:, :, 0] >= 0).sum() <= 2 * 400


def _write_det_rec(path, n=6, size=48, seed=0):
    """A detection .rec of JPEGs with packed labels [2, 5, obj...]."""
    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(seed)
    rec = recordio.MXRecordIO(str(path), "w")
    for i in range(n):
        img = rng.randint(0, 60, (size, size + 8, 3)).astype(np.uint8)
        objs = []
        for _ in range(1 + i % 3):
            x0, y0 = rng.uniform(0, 0.5, 2)
            x1, y1 = x0 + rng.uniform(0.2, 0.5), y0 + rng.uniform(0.2, 0.5)
            img[int(y0 * size):int(y1 * size),
                int(x0 * (size + 8)):int(x1 * (size + 8))] = 200
            objs += [rng.randint(0, 3), x0, y0, x1, y1]
        header = recordio.IRHeader(0, np.array([2, 5] + objs, np.float32),
                                   i, 0)
        rec.write(recordio.pack_img(header, img, quality=95))
    rec.close()


@pytest.mark.parametrize("augs", [
    dict(),
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
         std=True),
], ids=["plain", "crop_pad_mirror_normalize"])
def test_image_det_iter_matches_jax(tmp_path, augs):
    """``ImageDetIter`` over one seeded .rec with ``CreateDetAugmenter``,
    both packages from the same numpy seed: equal batches and labels,
    -1-padded, boxes in [0, 1]."""
    from mxnet_tpu import image as jimage
    from mxnet_tpu_torch import image as timage

    path = tmp_path / "det.rec"
    _write_det_rec(path)
    out = {}
    for name, image, ctx in (("jax", jimage, None), ("port", timage, cpu())):
        np.random.seed(11)
        it = image.ImageDetIter(
            batch_size=3, data_shape=(3, 32, 32), path_imgrec=str(path),
            aug_list=image.CreateDetAugmenter((3, 32, 32), **augs))
        if ctx is None:
            out[name] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                         for b in it]
        else:
            with ctx:
                out[name] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                             for b in it]
        out[name + "_dumps"] = [a.dumps() for a in it.auglist]
        out[name + "_label"] = it.provide_label[0].shape
    assert out["port_dumps"] == out["jax_dumps"]
    assert out["port_label"] == out["jax_label"] == (3, 3, 5)
    assert len(out["port"]) == len(out["jax"]) == 2
    for (gd, gl), (wd, wl) in zip(out["port"], out["jax"]):
        assert gd.shape == (3, 3, 32, 32) and gd.dtype == np.float32
        np.testing.assert_allclose(gd, wd, **FWD_TOL)
        np.testing.assert_allclose(gl, wl, **FWD_TOL)
        real = gl[gl[:, :, 0] >= 0]
        assert ((real[:, 1:] >= 0) & (real[:, 1:] <= 1)).all()
        assert (gl[gl[:, :, 0] < 0] == -1).all()


def test_det_horizontal_flip_moves_the_boxes():
    from mxnet_tpu_torch import image as timage

    img = np.zeros((4, 10, 3), np.uint8)
    img[:, :3] = 255
    lab = np.array([[1, 0.0, 0.0, 0.3, 1.0]], np.float32)
    np.random.seed(0)
    aug = timage.DetHorizontalFlipAug(1.0)
    out, new = aug(img, lab)
    assert (np.asarray(out)[:, -3:] == 255).all()
    np.testing.assert_allclose(new, [[1, 0.7, 0.0, 1.0, 1.0]], atol=1e-6)


def test_bench_ssd_json_keys_at_toy_size():
    cfg = dict(bench_ssd.VOC300, num_classes=3,
               base_channels=(8, 8, 16, 16, 8, 8))
    with cpu():
        out = bench_ssd.run(steps=2, warmup=1, batch=2, image=64, cfg=cfg,
                            device="cpu")
    for key in ("ms_per_step", "ms_min", "ms_max", "images_per_sec",
                "loss_first", "loss_last", "peak_mem_gib", "busy_share",
                "kernels_per_step", "device_name", "nvidia_smi"):
        assert key in out, key
    assert out["ms_min"] <= out["ms_per_step"] <= out["ms_max"]
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()
    # 32^2, 16^2, 8^2 maps of 4 anchors, then 4^2, 2^2, 1 of 6, 4, 4
    assert out["anchors"] == 4 * 1024 + 6 * 256 + 6 * 64 + 6 * 16 + 4 * 4 \
        + 4 * 1
    assert out["backend"] == "cpu" and out["busy_share"] is None
