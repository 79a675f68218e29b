"""The detection and vision op families, the port's against the JAX
package's, on the CPU: every op of ``ops/contrib_det.py`` and
``ops/vision_extra.py`` on the same numpy inputs through the JAX op
(jitted) and the port's op (on CPU tensors), and for each op that has a
gradient, in one or more of its cases, the gradient of sum(out * c), c a
fixed random cotangent.

Tolerances are ``tests/test_torch_operator.py``'s: outputs rtol 1e-4 /
atol 1e-5, gradients rtol 2e-3 / atol 2e-4.  Integer results (keep-sets,
matches, class targets) must be equal.  The cases the port could get
wrong: a padded gt ahead of a real one, two gts with the same best
anchor, tied negative scores, ``box_nms``'s first-k computation against
the full one, ``ROIPooling`` at .5 edges and ``Proposal``'s padding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import contrib_det as jdet
from mxnet_tpu.ops import vision_extra as jvis
from mxnet_tpu_torch.ops import contrib_det as tdet
from mxnet_tpu_torch.ops import vision_extra as tvis
from torch_one_thread import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _both(jfn, tfn, arrays, kw=None, grad=(), seed=0, exact=False):
    """Run both ops on ``arrays`` with ``kw``; compare the outputs, and
    the gradients with respect to the arrays at ``grad``."""
    kw = kw or {}
    f = jax.jit(functools.partial(jfn, **kw))
    want = [np.asarray(o) for o in _outs(f(*map(jnp.asarray, arrays)))]
    ts = [torch.tensor(a, requires_grad=i in grad)
          for i, a in enumerate(arrays)]
    got = _outs(tfn(*ts, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape, (g.shape, w.shape)
        if exact:
            np.testing.assert_array_equal(g.detach().numpy(), w)
        else:
            np.testing.assert_allclose(g.detach().numpy(), w, **FWD_TOL)
    if grad:
        rng = np.random.default_rng(seed)
        cots = [rng.standard_normal(w.shape).astype(np.float32)
                for w in want]

        def loss(*a):
            return sum(jnp.sum(o * c) for o, c in zip(_outs(f(*a)), cots))

        jg = jax.jit(jax.grad(loss, argnums=tuple(grad)))(
            *map(jnp.asarray, arrays))
        sum((o * torch.from_numpy(c)).sum()
            for o, c in zip(got, cots)).backward()
        for i, w in zip(grad, jg):
            np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(w),
                                       **GRAD_TOL)
    return [g.detach().numpy() for g in got], want


def _boxes(rng, *lead, lo=0.0, hi=1.0, min_wh=0.05):
    xy = rng.uniform(lo, hi - min_wh, lead + (2,))
    wh = rng.uniform(min_wh, (hi - lo) / 3, lead + (2,))
    return np.concatenate([xy, np.minimum(xy + wh, hi)],
                          axis=-1).astype(np.float32)


# -- contrib_det -----------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(1)
    _both(jdet.box_iou, tdet.box_iou,
          [_boxes(rng, 2, 7), _boxes(rng, 2, 5)], {"format": fmt})


def _nms_data(rng, B, N, classes=3, ties=False):
    score = rng.uniform(-0.2, 1.0, (B, N, 1))
    if ties:
        score[:, ::3] = 0.5
    cls = rng.randint(0, classes, (B, N, 1)).astype(np.float32)
    return np.concatenate([cls, score, _boxes(rng, B, N, min_wh=0.1)],
                          axis=-1).astype(np.float32)


NMS_CASES = [
    dict(),
    dict(topk=10),
    dict(topk=200),
    dict(id_index=0),
    dict(id_index=0, force_suppress=True, topk=12),
    dict(id_index=0, background_id=0),
    dict(valid_thresh=0.3, overlap_thresh=0.3),
    dict(in_format="center"),
]


@pytest.mark.parametrize("kw", NMS_CASES, ids=str)
def test_box_nms(kw):
    rng = np.random.RandomState(2)
    _both(jdet.box_nms, tdet.box_nms, [_nms_data(rng, 2, 60, ties=True)],
          kw, grad=(0,) if kw in NMS_CASES[:2] else ())


def test_box_nms_unbatched():
    rng = np.random.RandomState(3)
    _both(jdet.box_nms, tdet.box_nms, [_nms_data(rng, 1, 40)[0]],
          {"topk": 8, "id_index": 0})


def _nms_full(data, overlap_thresh, topk, id_index):
    """The greedy pass over all N rows (the JAX op's own loop), on
    tensors: the first-k computation must equal it."""
    B, N, _ = data.shape
    scores = data[:, :, 1]
    valid = scores > 0
    order = torch.argsort(-torch.where(valid, scores, float("-inf")),
                          dim=1, stable=True)
    k = N if topk <= 0 else min(topk, N)
    svalid = torch.gather(valid, 1, order) & (torch.arange(N) < k)
    sboxes = torch.gather(data[:, :, 2:6], 1,
                          order[:, :, None].expand(B, N, 4))
    iou = tdet._corner_iou(sboxes[:, :, None], sboxes[:, None])
    sup = iou > overlap_thresh
    if id_index >= 0:
        ids = torch.gather(data[:, :, id_index], 1, order)
        sup = sup & (ids[:, :, None] == ids[:, None])
    keep = torch.ones(B, N, dtype=torch.bool)
    for i in range(N):
        cur = keep[:, i] & svalid[:, i]
        keep = keep & ~(sup[:, i] & (torch.arange(N) > i) & cur[:, None])
    return keep & svalid


@pytest.mark.parametrize("topk", [-1, 7, 25])
def test_box_nms_first_k_equals_full(topk):
    """``box_nms`` runs its IoU and loop over the first k sorted rows only
    (k = topk, or the largest valid count): the same keep-set as the full
    N x N computation, with many invalid rows past k."""
    rng = np.random.RandomState(4)
    data = _nms_data(rng, 3, 80)
    data[0, :, 1] = np.where(np.arange(80) < 50, -0.5, data[0, :, 1])
    t = torch.from_numpy(data)
    keep_full = _nms_full(t, 0.4, topk, 0)
    out = tdet.box_nms(t, overlap_thresh=0.4, topk=topk, id_index=0)
    np.testing.assert_array_equal((out[:, :, 1] >= 0).numpy(),
                                  keep_full.numpy())
    got, want = _both(jdet.box_nms, tdet.box_nms, [data],
                      dict(overlap_thresh=0.4, topk=topk, id_index=0),
                      exact=True)
    assert (got[0][:, :, 1] >= 0).sum() > 0


@pytest.mark.parametrize("kw", [dict(threshold=0.1), dict(threshold=0.6),
                                dict(threshold=0.5, is_ascend=True),
                                dict(threshold=0.2, topk=2)], ids=str)
def test_bipartite_matching(kw):
    rng = np.random.RandomState(5)
    _both(jdet.bipartite_matching, tdet.bipartite_matching,
          [rng.uniform(0, 1, (3, 6, 4)).astype(np.float32)], kw, exact=True)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2)),
    dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5, 3, 1 / 3)),
    dict(sizes=(0.9,), ratios=(1, 2, 0.5), clip=True),
    dict(sizes=(0.3,), ratios=(1,), steps=(0.2, 0.1), offsets=(0.2, 0.7)),
], ids=str)
def test_multibox_prior(kw):
    x = np.zeros((1, 2, 5, 7), np.float32)
    _both(jdet.multibox_prior, tdet.multibox_prior, [x], kw)


def _target_inputs(rng, B=3, M=4, C=4):
    anchors = np.asarray(jdet.multibox_prior(
        jnp.zeros((1, 1, 6, 6)), sizes=(0.3, 0.15), ratios=(1, 2, 0.5)))
    N = anchors.shape[1]
    lab = -np.ones((B, M, 5), np.float32)
    for b in range(B):
        n = 1 + b
        lab[b, :n, 0] = rng.randint(0, C - 1, n)
        lab[b, :n, 1:] = _boxes(rng, n, min_wh=0.1)
    # a padded gt ahead of a real one: its best anchor is index 0 too
    lab[0, 1] = -1
    lab[0, 2] = [2, 0.0, 0.0, 0.12, 0.12]       # best anchor 0
    # two gts with the same best anchor
    lab[1, 0, 1:] = [0.4, 0.4, 0.7, 0.7]
    lab[1, 1, 1:] = [0.42, 0.41, 0.7, 0.72]
    pred = rng.uniform(0, 1, (B, C, N)).astype(np.float32)
    pred[:, :, ::4] = 0.25                       # tied negative scores
    return anchors, lab, pred


@pytest.mark.parametrize("kw", [
    dict(),
    dict(negative_mining_ratio=3),
    dict(negative_mining_ratio=2, minimum_negative_samples=20,
         overlap_threshold=0.4, ignore_label=-2),
    dict(negative_mining_ratio=3, negative_mining_thresh=0.3,
         variances=(0.2, 0.2, 0.1, 0.1)),
], ids=str)
def test_multibox_target(kw):
    anchors, lab, pred = _target_inputs(np.random.RandomState(6))
    got, want = _both(jdet.multibox_target, tdet.multibox_target,
                      [anchors, lab, pred], kw)
    np.testing.assert_array_equal(got[1], want[1])         # loc_mask
    np.testing.assert_array_equal(got[2], want[2])         # cls_target
    # the padded gt ahead of the real one takes anchor 0: class 0 + 1 - 1
    assert got[2][0, 0] == want[2][0, 0]


def test_multibox_target_force_match_shares_an_anchor():
    """Two gts whose best anchor is the same: the anchor takes the first;
    a padded gt before a real gt that claims anchor 0 names it first."""
    anchors = np.array([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9],
                         [0.1, 0.1, 0.3, 0.3]]], np.float32)
    lab = np.array([[[-1, -1, -1, -1, -1], [1, 0.0, 0.0, 0.1, 0.1],
                     [0, 0.55, 0.5, 0.9, 0.85]],
                    [[3, 0.5, 0.5, 0.8, 0.8], [2, 0.52, 0.5, 0.9, 0.9],
                     [-1, 0, 0, 0, 0]]], np.float32)
    pred = np.full((2, 5, 3), 0.2, np.float32)
    got, want = _both(jdet.multibox_target, tdet.multibox_target,
                      [anchors, lab, pred], dict(negative_mining_ratio=1))
    np.testing.assert_array_equal(got[2], want[2])
    # sample 0: the padded gt (first, best anchor 0) names anchor 0, which
    # the real gt 1 claims: class -1 + 1 = 0; anchor 2, the one negative
    # mined (2 matched x 1), is background
    np.testing.assert_array_equal(got[2][0], [0.0, 1.0, 0.0])
    # sample 1: both gts claim anchor 1, which takes the first (class 3 + 1,
    # not gt 1's, its best IoU); anchors 0 and 2 tie as negatives and the
    # one mined is the first by index
    np.testing.assert_array_equal(got[2][1], [0.0, 4.0, -1.0])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nms_topk=20, nms_threshold=0.3),
    dict(force_suppress=True, threshold=0.3),
    dict(background_id=1, clip=False),
], ids=str)
def test_multibox_detection(kw):
    rng = np.random.RandomState(7)
    anchors = np.asarray(jdet.multibox_prior(
        jnp.zeros((1, 1, 5, 5)), sizes=(0.4, 0.2), ratios=(1, 2)))
    N = anchors.shape[1]
    logits = rng.standard_normal((2, 4, N)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.standard_normal((2, N * 4)) * 0.5).astype(np.float32)
    _both(jdet.multibox_detection, tdet.multibox_detection,
          [prob.astype(np.float32), loc, anchors], kw,
          grad=(0, 1) if not kw else ())


def _rois(rng, R, H, W, B=2, scale=1.0):
    x1 = rng.uniform(0, W - 3, R)
    y1 = rng.uniform(0, H - 3, R)
    x2 = np.minimum(x1 + rng.uniform(1, W / 2, R), W - 1)
    y2 = np.minimum(y1 + rng.uniform(1, H / 2, R), H - 1)
    b = rng.randint(0, B, R)
    return (np.stack([b, x1, y1, x2, y2], 1) / [1, scale, scale, scale,
                                                  scale]).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pooling(scale):
    rng = np.random.RandomState(8)
    data = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    rois = _rois(rng, 6, 12, 10, scale=scale)
    # corners at .5: round half to even (2.5 -> 2, 3.5 -> 4)
    rois[0, 1:] = np.array([2.5, 3.5, 7.5, 8.5]) / scale
    rois[1, 1:] = np.array([0.5, 1.5, 4.5, 5.5]) / scale
    # past the map: bins with no pixel give 0
    rois[2, 1:] = np.array([8.0, 10.0, 14.0, 15.0]) / scale
    _both(jdet.roi_pooling, tdet.roi_pooling, [data, rois],
          dict(pooled_size=(3, 2), spatial_scale=scale), grad=(0,))


@pytest.mark.parametrize("kw", [
    dict(pooled_size=(2, 3), spatial_scale=1.0),
    dict(pooled_size=(3, 3), spatial_scale=0.5, sample_ratio=1),
    dict(pooled_size=(2, 2), spatial_scale=1.0, aligned=True),
    dict(pooled_size=(2, 1), spatial_scale=0.25, sample_ratio=3,
         aligned=True),
], ids=str)
def test_roi_align(kw):
    rng = np.random.RandomState(9)
    data = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    s = kw["spatial_scale"]
    rois = _rois(rng, 5, 9, 11, scale=s)
    rois[0, 1:] = np.array([-1.0, 2.0, 12.5, 9.5]) / s      # clamped taps
    rois[1, 1:] = np.array([3.0, 3.0, 3.2, 3.1]) / s        # tiny ROI
    _both(jdet.roi_align, tdet.roi_align, [data, rois], kw,
          grad=(0,) if kw.get("aligned") else ())


# -- vision_extra ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(nsize=3), dict(nsize=5, alpha=1e-2,
                                                     beta=0.5, knorm=1.0)],
                         ids=str)
def test_lrn(kw):
    x = np.random.RandomState(10).standard_normal((2, 6, 3, 4)) \
        .astype(np.float32)
    _both(jvis.lrn, tvis.lrn, [x], kw, grad=(0,))


def test_bilinear_sampler():
    rng = np.random.RandomState(11)
    data = rng.standard_normal((2, 3, 6, 7)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 2, 4, 5)).astype(np.float32)
    _both(jvis.bilinear_sampler, tvis.bilinear_sampler, [data, grid],
          grad=(0, 1))


@pytest.mark.parametrize("kind", ["affine", "warp"])
def test_grid_generator(kind):
    rng = np.random.RandomState(12)
    if kind == "affine":
        data = rng.standard_normal((2, 6)).astype(np.float32)
        kw = dict(transform_type="affine", target_shape=(4, 5))
    else:
        data = rng.standard_normal((2, 2, 4, 5)).astype(np.float32)
        kw = dict(transform_type="warp")
    _both(jvis.grid_generator, tvis.grid_generator, [data], kw, grad=(0,))


def test_spatial_transformer():
    rng = np.random.RandomState(13)
    data = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    loc = (np.array([[0.9, 0.1, 0.05, -0.1, 0.8, 0.1]] * 2)
           + rng.standard_normal((2, 6)) * 0.05).astype(np.float32)
    _both(jvis.spatial_transformer, tvis.spatial_transformer, [data, loc],
          dict(target_shape=(5, 6)), grad=(0, 1))


@pytest.mark.parametrize("kw", [dict(offset=(1, 2), h_w=(3, 4)),
                                dict(h_w=(4, 4), center_crop=True),
                                dict(like=True)], ids=str)
def test_crop(kw):
    rng = np.random.RandomState(14)
    arrays = [rng.standard_normal((2, 3, 7, 8)).astype(np.float32)]
    if kw.pop("like", False):
        arrays.append(np.zeros((1, 1, 5, 6), np.float32))
    _both(jvis.crop_op, tvis.crop_op, arrays, kw, grad=(0,))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
    dict(kernel_size=1, max_displacement=1, stride1=2, is_multiply=False),
], ids=str)
def test_correlation(kw):
    rng = np.random.RandomState(15)
    a = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    b = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    _both(jvis.correlation, tvis.correlation, [a, b], kw,
          grad=(0, 1) if kw else ())


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), num_filter=4, pad=(1, 1)),
    dict(kernel=(2, 2), num_filter=4, stride=(2, 2), dilate=(2, 1),
         num_group=2, num_deformable_group=2),
    dict(kernel=(1, 3), num_filter=2, pad=(0, 1), no_bias=True),
], ids=str)
def test_deformable_convolution(kw):
    rng = np.random.RandomState(16)
    C, H, W = 4, 7, 6
    kh, kw_ = kw["kernel"]
    sh, sw = kw.get("stride", (1, 1))
    dh, dw = kw.get("dilate", (1, 1))
    ph, pw = kw.get("pad", (0, 0))
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw_ - 1) + 1)) // sw + 1
    ndg = kw.get("num_deformable_group", 1)
    data = rng.standard_normal((2, C, H, W)).astype(np.float32)
    offset = (rng.standard_normal((2, ndg * 2 * kh * kw_, Ho, Wo)) * 1.3) \
        .astype(np.float32)
    weight = rng.standard_normal((kw["num_filter"],
                                  C // kw.get("num_group", 1), kh, kw_)) \
        .astype(np.float32)
    bias = rng.standard_normal(kw["num_filter"]).astype(np.float32)
    _both(jvis.deformable_convolution, tvis.deformable_convolution,
          [data, offset, weight, bias], kw,
          grad=() if kw.get("no_bias") else (0, 1, 2, 3))


@pytest.mark.parametrize("kw", [dict(output_dim=2, pooled_size=2),
                                dict(output_dim=2, pooled_size=2,
                                     group_size=3, spatial_scale=0.5)],
                         ids=str)
def test_psroi_pooling(kw):
    rng = np.random.RandomState(17)
    g = kw.get("group_size") or kw["pooled_size"]
    data = rng.standard_normal((2, kw["output_dim"] * g * g, 8, 9)) \
        .astype(np.float32)
    rois = _rois(rng, 4, 8, 9, scale=kw.get("spatial_scale", 1.0))
    _both(jvis.psroi_pooling, tvis.psroi_pooling, [data, rois], kw,
          grad=(0,) if "group_size" in kw else ())


def _proposal_inputs(rng, B, A, H, W):
    cls = rng.uniform(0, 1, (B, 2 * A, H, W)).astype(np.float32)
    cls[:, A:, ::2, ::3] = 0.5                    # tied scores
    bbox = (rng.standard_normal((B, 4 * A, H, W)) * 0.2).astype(np.float32)
    info = np.array([[H * 16, W * 16, 1.0], [H * 16 - 20, W * 16, 0.5]],
                    np.float32)[:B]
    return [cls, bbox, info]


@pytest.mark.parametrize("kw", [
    dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=10, scales=(8,),
         rpn_min_size=4),
    dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=30, scales=(4, 8),
         threshold=0.5, output_score=True, rpn_min_size=1),
], ids=str)
def test_proposal(kw):
    A = len(kw["scales"]) * 3
    arrays = _proposal_inputs(np.random.RandomState(18), 2, A, 5, 6)
    _both(jvis.proposal, tvis.proposal, arrays, kw)


def test_proposal_pads_with_the_first_box():
    """Fewer survivors than ``rpn_post_nms_top_n``: the tail repeats the
    image's first box and score, as the reference pads."""
    arrays = _proposal_inputs(np.random.RandomState(19), 2, 3, 3, 3)
    # every box the same: NMS keeps one an image
    arrays[1][:] = 0.0
    kw = dict(rpn_pre_nms_top_n=27, rpn_post_nms_top_n=8, scales=(8,),
              threshold=0.01, rpn_min_size=1, output_score=True,
              feature_stride=1)
    got, want = _both(jvis.proposal, tvis.proposal, arrays, kw)
    rois = got[0].reshape(2, 8, 5)
    assert (rois[:, 1:, 1:] == rois[:, :1, 1:]).all()
    np.testing.assert_array_equal(rois[:, :, 0], [[0] * 8, [1] * 8])


def test_proposal_channel_mismatch_raises():
    arrays = [torch.zeros(1, 6, 4, 4), torch.zeros(1, 12, 4, 4),
              torch.tensor([[64.0, 64.0, 1.0]])]
    with pytest.raises(ValueError, match="channels"):
        tvis.proposal(*arrays)


def test_nd_contrib_namespace_carries_detection_ops():
    """``mx.nd.contrib`` names the ``_contrib_*`` ops; Proposal then
    ROIAlign chain through it (the Faster R-CNN path)."""
    import mxnet_tpu_torch as mx

    for name in ("Proposal", "ROIAlign", "box_nms", "box_iou",
                 "DeformableConvolution", "PSROIPooling",
                 "bipartite_matching"):
        assert hasattr(mx.nd.contrib, name), name
    rs = np.random.RandomState(0)
    with mx.cpu():
        rois = mx.nd.contrib.Proposal(
            mx.nd.array(rs.rand(1, 6, 4, 4)),
            mx.nd.array(rs.randn(1, 12, 4, 4) * 0.1),
            mx.nd.array([[64, 64, 1.0]]), rpn_pre_nms_top_n=16,
            rpn_post_nms_top_n=4, feature_stride=16, scales=(8,),
            rpn_min_size=1)
        pooled = mx.nd.contrib.ROIAlign(
            mx.nd.array(rs.randn(1, 8, 4, 4)), rois, pooled_size=(2, 2),
            spatial_scale=1.0 / 16)
    assert rois.shape == (4, 5)
    assert pooled.shape == (4, 8, 2, 2)
