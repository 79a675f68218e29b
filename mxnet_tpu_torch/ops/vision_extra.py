"""Vision ops beyond convolution and pooling.

Counterpart of ``mxnet_tpu/ops/vision_extra.py`` (reference:
src/operator/ lrn.cc, bilinear_sampler.cc, grid_generator.cc,
spatial_transformer.cc, crop.cc, correlation.cc and src/operator/contrib/
proposal.cc, multi_proposal.cc, deformable_convolution.cc,
psroi_pooling.cc), under the JAX registry's names and aliases.

The samplers gather the four taps of each point with flat indices and
blend them; a tap outside the map reads 0 (``_bilinear_gather``), unlike
``ROIAlign``'s clamp.  ``DeformableConvolution`` builds the sampled im2col
columns, ordered (c, ky, kx) as the weight (O, C/g, kh, kw) is, and runs
one matrix product.  ``Proposal`` keeps the reference's fixed-length
output: exactly ``rpn_post_nms_top_n`` ROIs an image, the tail padded with
the image's first box.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .contrib_det import _greedy_keep
from .registry import register


# -- LRN -----------------------------------------------------------------------

@register("LRN", aliases=("lrn",))
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across channels (reference: lrn.cc):
    ``x / (knorm + alpha / nsize * sum_local x^2) ^ beta``, the window sum
    a difference of a padded cumulative sum."""
    half = nsize // 2
    sq = torch.square(data)
    pad = [0, 0] * (data.dim() - 2) + [half, half]
    csum = torch.cumsum(F.pad(sq, pad), dim=1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
    C = data.shape[1]
    local = csum[:, nsize:nsize + C] - csum[:, :C]
    return data * torch.pow(knorm + (alpha / nsize) * local, -beta)


# -- bilinear sampling family --------------------------------------------------

def _bilinear_gather(data, gx, gy):
    """Sample NCHW ``data`` at fractional pixel coordinates ``gx``, ``gy``
    (B, ...) -> (B, C, ...); a tap outside the map reads 0."""
    B, C, H, W = data.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    dx = gx - x0
    dy = gy - y0
    flat = data.reshape(B, C, H * W)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        lin = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
        vals = torch.gather(flat, 2, lin).reshape(B, C, *xi.shape[1:])
        return vals * inb[:, None].to(data.dtype)

    w00 = ((1 - dx) * (1 - dy))[:, None]
    w01 = (dx * (1 - dy))[:, None]
    w10 = ((1 - dx) * dy)[:, None]
    w11 = (dx * dy)[:, None]
    return (tap(x0, y0) * w00 + tap(x0 + 1, y0) * w01
            + tap(x0, y0 + 1) * w10 + tap(x0 + 1, y0 + 1) * w11)


@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, cudnn_off=False):
    """Sample ``data`` (B, C, H, W) at ``grid`` (B, 2, Ho, Wo) of
    normalised [-1, 1] (x, y) coordinates (reference:
    bilinear_sampler.cc)."""
    B, C, H, W = data.shape
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return _bilinear_gather(data, gx, gy)


@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid (reference: grid_generator.cc).  ``affine``: data
    (B, 6), a row-major 2x3 matrix -> (B, 2, H, W); ``warp``: data (B, 2,
    H, W), a flow field -> the normalised grid of (x + fx, y + fy)."""
    if transform_type == "affine":
        B = data.shape[0]
        H, W = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(B, 2, 3)
        ys = torch.linspace(-1.0, 1.0, H, device=data.device,
                            dtype=data.dtype)
        xs = torch.linspace(-1.0, 1.0, W, device=data.device,
                            dtype=data.dtype)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, H * W)
        return torch.einsum("bij,jk->bik", theta, base).reshape(B, 2, H, W)
    if transform_type == "warp":
        B, _, H, W = data.shape
        ys = torch.arange(H, device=data.device, dtype=data.dtype)
        xs = torch.arange(W, device=data.device, dtype=data.dtype)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        x = (data[:, 0] + gx) * 2.0 / max(W - 1, 1) - 1.0
        y = (data[:, 1] + gy) * 2.0 / max(H - 1, 1) - 1.0
        return torch.stack([x, y], dim=1)
    raise ValueError(f"unknown transform_type {transform_type}")


@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """Affine spatial transformer: ``GridGenerator`` then
    ``BilinearSampler`` (reference: spatial_transformer.cc)."""
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


@register("Crop", aliases=("crop",))
def crop_op(data, *like, offset=(0, 0), h_w=(0, 0), num_args=None,
            center_crop=False):
    """The legacy Crop (reference: crop.cc): NCHW ``data`` cut to ``h_w``
    (or to a second input's spatial shape) at ``offset``, or centred."""
    H, W = data.shape[2], data.shape[3]
    if like:
        th, tw = like[0].shape[2], like[0].shape[3]
    else:
        th, tw = int(h_w[0]) or H, int(h_w[1]) or W
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    # lax.dynamic_slice clamps the start so that the window fits
    oy = min(max(oy, 0), H - th)
    ox = min(max(ox, 0), W - tw)
    return data[:, :, oy:oy + th, ox:ox + tw]


# -- Correlation (FlowNet) -----------------------------------------------------

@register("Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """The FlowNet correlation layer (reference: correlation.cc): output
    channel (dy, dx) is the channel mean of data1 times data2 shifted by
    the displacement, summed over a ``kernel_size`` window."""
    B, C, H, W = data1.shape
    p = int(pad_size)
    d1 = F.pad(data1, [p, p, p, p])
    d2 = F.pad(data2, [p, p, p, p])
    md, s1, s2 = int(max_displacement), int(stride1), int(stride2)
    k = int(kernel_size)
    bk = k // 2
    Hp, Wp = H + 2 * p, W + 2 * p
    y0 = x0 = md + bk
    Ho = (Hp - 2 * (md + bk) - 1) // s1 + 1
    Wo = (Wp - 2 * (md + bk) - 1) // s1 + 1
    outs = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            shifted = torch.roll(d2, (-dy, -dx), dims=(2, 3))
            prod = d1 * shifted if is_multiply else torch.abs(d1 - shifted)
            if k > 1:
                # lax.reduce_window "SAME": (k-1)//2 before, the rest after
                lo = (k - 1) // 2
                hi = k - 1 - lo
                prod = F.avg_pool2d(F.pad(prod, [lo, hi, lo, hi]), k,
                                    stride=1, divisor_override=1)
            m = prod.mean(dim=1)
            outs.append(m[:, y0:y0 + (Ho - 1) * s1 + 1:s1,
                          x0:x0 + (Wo - 1) * s1 + 1:s1])
    return torch.stack(outs, dim=1)


# -- DeformableConvolution -----------------------------------------------------

def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x)
                                                             for x in v)


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution", "deformable_convolution"))
def deformable_convolution(data, offset, weight, bias=None, kernel=None,
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=None, num_group=1,
                           num_deformable_group=1, no_bias=False,
                           workspace=1024, layout=None):
    """Deformable convolution v1 (reference:
    contrib/deformable_convolution.cc, Dai et al. 2017): each kernel tap
    samples the input at its grid position plus a learned offset a
    location, bilinearly; the sampled columns feed one matrix product."""
    B, C, H, W = data.shape
    O, Cg, kh, kw = weight.shape
    sh, sw = _pair(stride)
    dh, dw = _pair(dilate)
    ph, pw = _pair(pad)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    ndg = int(num_deformable_group)
    oy = torch.arange(Ho, device=data.device) * sh - ph
    ox = torch.arange(Wo, device=data.device) * sw - pw
    gy0, gx0 = torch.meshgrid(oy.to(data.dtype), ox.to(data.dtype),
                              indexing="ij")
    off = offset.reshape(B, ndg, kh * kw, 2, Ho, Wo)
    cpg = C // ndg
    cols = []
    for t in range(kh * kw):
        ky, kx = divmod(t, kw)
        cols.append(torch.cat([
            _bilinear_gather(data[:, g * cpg:(g + 1) * cpg],
                             gx0[None] + kx * dw + off[:, g, t, 1],
                             gy0[None] + ky * dh + off[:, g, t, 0])
            for g in range(ndg)], dim=1))                # (B, C, Ho, Wo)
    colmat = torch.stack(cols, dim=2).reshape(B, C * kh * kw, Ho * Wo)
    wmat = weight.reshape(O, Cg * kh * kw)
    if num_group == 1:
        out = torch.matmul(wmat, colmat)
    else:
        og = O // num_group
        colg = colmat.reshape(B, num_group, Cg * kh * kw, Ho * Wo)
        wg = wmat.reshape(num_group, og, Cg * kh * kw)
        out = torch.matmul(wg[None], colg).reshape(B, O, Ho * Wo)
    out = out.reshape(B, O, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -- PSROIPooling --------------------------------------------------------------

@register("_contrib_PSROIPooling", aliases=("psroi_pooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=None,
                  pooled_size=7, group_size=0):
    """Position-sensitive ROI pooling (reference: contrib/psroi_pooling.cc,
    R-FCN): ``data`` (B, output_dim*g*g, H, W), ``rois`` (R, 5) -> (R,
    output_dim, P, P); each bin averages a fixed 2x2 grid of bilinear
    samples from its own group of ``output_dim`` channels."""
    g = int(group_size) or int(pooled_size)
    P = int(pooled_size)
    od = int(output_dim)
    B, CC, H, W = data.shape
    dt = data.dtype
    b = rois[:, 0].to(torch.int64)
    x1, y1 = rois[:, 1] * spatial_scale, rois[:, 2] * spatial_scale
    x2, y2 = rois[:, 3] * spatial_scale, rois[:, 4] * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=0.1) / P
    bin_h = torch.clamp(y2 - y1, min=0.1) / P
    quarter = torch.tensor([0.25, 0.75], dtype=dt, device=data.device)
    imgs = data[b]                                       # (R, CC, H, W)
    out = []
    for py in range(P):
        for px in range(P):
            gy, gx = py * g // P, px * g // P
            sy = torch.clamp(y1[:, None] + (py + quarter[None]) *
                             bin_h[:, None], 0, H - 1)  # (R, 2)
            sx = torch.clamp(x1[:, None] + (px + quarter[None]) *
                             bin_w[:, None], 0, W - 1)
            chan0 = (gy * g + gx) * od
            vals = _bilinear_gather(imgs[:, chan0:chan0 + od],
                                    sx[:, None, :].expand(-1, 2, 2),
                                    sy[:, :, None].expand(-1, 2, 2))
            out.append(vals.mean(dim=(2, 3)))
    return torch.stack(out, dim=-1).reshape(-1, od, P, P)


# -- Proposal (RPN) ------------------------------------------------------------

def _make_anchors(feature_stride, scales, ratios):
    """The reference's anchors (proposal.cc GenerateAnchors), numpy."""
    base = np.array([1, 1, feature_stride, feature_stride]) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = int(round(np.sqrt(size / r)))
        hs = int(round(ws * r))
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(anchors, np.float32)


def _iou_plus_one(a, b):
    """IoU of pixel-inclusive boxes (+1 on each extent), broadcasting."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(br - tl + 1, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


@register("_contrib_Proposal",
          aliases=("Proposal", "proposal", "_contrib_MultiProposal",
                   "MultiProposal"))
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, feature_stride=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), rpn_min_size=16,
             iou_loss=False, output_score=False):
    """The RPN proposal op (reference: contrib/proposal.cc): decode every
    anchor's box, drop those under the minimum size (score -1), keep the
    ``rpn_pre_nms_top_n`` best (a stable sort: ties by index, as
    ``lax.top_k``), greedy NMS at ``threshold``, then the survivors in
    score order, cut or padded with the first box to exactly
    ``rpn_post_nms_top_n`` ROIs an image: (B * post, 5) rows [batch_idx,
    x1, y1, x2, y2]."""
    B, A2, H, W = cls_prob.shape
    A = len(scales) * len(ratios)
    if A2 != 2 * A:
        raise ValueError(
            f"Proposal: cls_prob has {A2} channels but scales×ratios "
            f"defines {A} anchors (need 2·{A} channels: bg+fg per anchor)")
    dev, dt = cls_prob.device, cls_prob.dtype
    anchors = torch.as_tensor(_make_anchors(feature_stride, scales, ratios),
                              device=dev)
    sy = torch.arange(H, device=dev, dtype=torch.float32) * feature_stride
    sx = torch.arange(W, device=dev, dtype=torch.float32) * feature_stride
    shift_y, shift_x = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([shift_x, shift_y, shift_x, shift_y],
                         dim=-1).reshape(-1, 4)
    anc = (anchors[None] + shifts[:, None]).reshape(-1, 4)   # (H*W*A, 4)
    pre_n = min(int(rpn_pre_nms_top_n), A * H * W)
    post_n = int(rpn_post_nms_top_n)

    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    d = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    ws = anc[:, 2] - anc[:, 0] + 1.0
    hs = anc[:, 3] - anc[:, 1] + 1.0
    cx = anc[:, 0] + 0.5 * (ws - 1)
    cy = anc[:, 1] + 0.5 * (hs - 1)
    ncx = d[..., 0] * ws + cx
    ncy = d[..., 1] * hs + cy
    nw = torch.exp(torch.clamp(d[..., 2], -10, 10)) * ws
    nh = torch.exp(torch.clamp(d[..., 3], -10, 10)) * hs
    boxes = torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                         ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)],
                        dim=-1)                               # (B, HWA, 4)
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                      im_info[:, 1] - 1, im_info[:, 0] - 1], dim=-1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi[:, None, :])
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    big = ((boxes[..., 2] - boxes[..., 0] + 1 >= min_size)
           & (boxes[..., 3] - boxes[..., 1] + 1 >= min_size))
    scores = torch.where(big, scores, torch.full_like(scores, -1.0))
    order = torch.argsort(-scores, dim=1, stable=True)[:, :pre_n]
    top_scores = torch.gather(scores, 1, order)
    top_boxes = torch.gather(boxes, 1, order[:, :, None].expand(B, pre_n, 4))
    valid = top_scores > -1.0
    # rows past the batch's last valid one neither stay nor suppress
    k = int(valid.sum(dim=1).max()) if pre_n else 0
    keep = torch.zeros_like(valid)
    if k:
        head = top_boxes[:, :k]
        iou = _iou_plus_one(head[:, :, None, :], head[:, None, :, :])
        keep[:, :k] = _greedy_keep(iou > threshold, valid[:, :k])
    # survivors to the front in score order, cut or padded to post_n
    pos = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :post_n]
    out_boxes = torch.gather(top_boxes, 1, pos[:, :, None].expand(B, -1, 4))
    out_scores = torch.gather(top_scores, 1, pos)
    pad = torch.arange(post_n, device=dev)[None] >= keep.sum(dim=1,
                                                             keepdim=True)
    out_boxes = torch.where(pad[:, :, None], out_boxes[:, :1], out_boxes)
    out_scores = torch.where(pad, out_scores[:, :1], out_scores)
    batch_idx = torch.arange(B, device=dev, dtype=dt).repeat_interleave(
        post_n)
    rois = torch.cat([batch_idx[:, None], out_boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois
