"""Detection ops (the SSD and Faster R-CNN family).

Counterpart of ``mxnet_tpu/ops/contrib_det.py`` (reference:
src/operator/contrib/ multibox_*.cc, bounding_box.cc, roi_align.cc and
src/operator/roi_pooling.cc): ``box_iou``, ``box_nms``,
``bipartite_matching``, ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``ROIPooling`` and ``ROIAlign``, under the JAX
registry's names and aliases.  Where the JAX ops ``jax.vmap`` a per-sample
function, these batch over the leading axis with tensor ops; the outputs
keep the padded, fixed-shape contract (a suppressed row keeps its place
with score and id -1).

Greedy loops.  ``box_nms`` and ``bipartite_matching`` run their greedy
loop in Python over batched tensors: one step is a few kernels over the
whole batch, with no readback inside the loop.  ``box_nms`` builds its
IoU matrix and runs its loop over the first ``k`` score-sorted rows only:
a row ranked at or past ``topk``, or invalid, is never kept and never
suppresses another, so the rows past ``k`` cannot change the result.  With
``topk <= 0``, ``k`` is the batch's largest count of valid rows, read back
once a call.  At an SSD-300 head (134296 anchors) the full N x N matrix
would take 72 GB a sample.

Ties.  Sorts are stable (``stable=True``), as ``jnp.argsort`` is, and
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so
tied scores order by index in both packages.
"""

from __future__ import annotations

import functools

import torch

from .registry import register


def _corner_iou(a, b):
    """IoU of (..., 4) corner boxes against (..., 4), broadcasting."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _center_to_corner(b):
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU (reference: bounding_box.cc box_iou)."""
    if format == "center":
        lhs = _center_to_corner(lhs)
        rhs = _center_to_corner(rhs)
    return _corner_iou(lhs[..., :, None, :], rhs[..., None, :, :])


def _greedy_keep(suppress, svalid):
    """The greedy pass over (B, k, k) ``suppress`` (row i suppresses a
    later column j) and (B, k) ``svalid``: row i, if still kept and valid,
    drops the later rows it overlaps.  Returns the (B, k) kept rows."""
    k = svalid.shape[1]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=svalid.device).triu(diagonal=1)
    suppress = suppress & later
    keep = torch.ones_like(svalid)
    for i in range(k):
        cur = keep[:, i] & svalid[:, i]
        keep = keep & ~(suppress[:, i] & cur[:, None])
    return keep & svalid


@register("_contrib_box_nms", aliases=("box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS with the reference's padded output: the rows come back
    sorted by score, the same shape as ``data``; a suppressed or invalid
    row has score (and id) -1.  ``data`` is (..., N, K) with the score at
    ``score_index`` and the box at ``coord_start``..``coord_start + 4``."""
    batched = data.dim() == 3
    if not batched:
        data = data[None]
    B, N, _ = data.shape
    scores = data[:, :, score_index]
    boxes = data[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (data[:, :, id_index] != background_id)
    order = torch.argsort(-torch.where(valid, scores, float("-inf")), dim=1,
                          stable=True)
    if topk > 0:
        k = min(int(topk), N)
    else:
        k = int(valid.sum(dim=1).max()) if N else 0
    out = torch.gather(data, 1, order[:, :, None].expand_as(data))
    keep = torch.zeros(B, N, dtype=torch.bool, device=data.device)
    if k:
        head = order[:, :k]
        svalid = torch.gather(valid, 1, head)
        sboxes = torch.gather(boxes, 1, head[:, :, None].expand(B, k, 4))
        iou = _corner_iou(sboxes[:, :, None, :], sboxes[:, None, :, :])
        suppress = iou > overlap_thresh
        if id_index >= 0 and not force_suppress:
            sids = torch.gather(data[:, :, id_index], 1, head)
            suppress = suppress & (sids[:, :, None] == sids[:, None, :])
        keep[:, :k] = _greedy_keep(suppress, svalid)
    minus = torch.full_like(scores, -1.0)
    cols = list(out.unbind(dim=2))
    cols[score_index] = torch.where(keep, cols[score_index], minus)
    if id_index >= 0:
        cols[id_index] = torch.where(keep, cols[id_index], minus)
    out = torch.stack(cols, dim=2)
    return out if batched else out[0]


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",))
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """Greedy bipartite matching (reference: bounding_box.cc): (B, N, M)
    pairwise scores -> (row_match (B, N), col_match (B, M)), -1 where
    unmatched.  Each of the ``min(N, M)`` (or ``topk``) steps takes the
    best remaining pair, matches it if it passes ``threshold`` and both
    ends are free, and blocks its row and column."""
    B, N, M = data.shape
    dev = data.device
    s = data.to(torch.float32)
    row = torch.full((B, N), -1.0, device=dev)
    col = torch.full((B, M), -1.0, device=dev)
    k = min(N, M) if topk <= 0 else min(int(topk), min(N, M))
    blocked = float("inf") if is_ascend else float("-inf")
    rows = torch.arange(N, device=dev)
    colr = torch.arange(M, device=dev)
    for _ in range(k):
        flat = s.reshape(B, N * M)
        idx = torch.argmin(flat, dim=1) if is_ascend else \
            torch.argmax(flat, dim=1)
        i, j = idx // M, idx % M
        val = flat.gather(1, idx[:, None])[:, 0]
        ok = (val <= threshold) if is_ascend else (val >= threshold)
        ok = ok & (row.gather(1, i[:, None])[:, 0] < 0) & \
            (col.gather(1, j[:, None])[:, 0] < 0)
        hit_r = rows[None, :] == i[:, None]
        hit_c = colr[None, :] == j[:, None]
        row = torch.where(ok[:, None] & hit_r, j[:, None].to(row.dtype), row)
        col = torch.where(ok[:, None] & hit_c, i[:, None].to(col.dtype), col)
        s = s.masked_fill(hit_r[:, :, None] | hit_c[:, None, :], blocked)
    return row, col


@register("MultiBoxPrior", aliases=("multibox_prior",))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a (B, C, H, W) feature map (reference:
    multibox_prior.cc): (1, H*W*(S+R-1), 4) corners, location-major; at
    each location every size with ``ratios[0]``, then every later ratio
    with ``sizes[0]``.  The anchors depend on the map's shape alone: they
    are computed once on the host for each shape and device and kept
    there, so a forward makes no copy from the host for them (each call
    returns its own copy of the kept tensor)."""
    return _prior(int(data.shape[2]), int(data.shape[3]),
                  tuple(float(s) for s in sizes),
                  tuple(float(r) for r in ratios), bool(clip),
                  tuple(float(s) for s in steps),
                  tuple(float(o) for o in offsets), data.device).clone()


@functools.lru_cache(maxsize=256)
def _prior(H, W, sizes, ratios, clip, steps, offsets, device):
    f32 = torch.float32
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=f32) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=f32) + offsets[1]) * step_x
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    cyx = torch.stack([gy, gx], dim=-1).reshape(H * W, 2)

    def root(r):
        return torch.sqrt(torch.tensor(r, dtype=f32))

    wh = [(s * root(ratios[0]), s / root(ratios[0])) for s in sizes]
    wh += [(sizes[0] * root(r), sizes[0] / root(r)) for r in ratios[1:]]
    wh = torch.stack([torch.stack(p) for p in wh])           # (A, 2) (w, h)
    A = wh.shape[0]
    centers = cyx.repeat_interleave(A, dim=0)                 # (HW*A, 2)
    whs = wh.repeat(H * W, 1)
    anchors = torch.stack([centers[:, 1] - whs[:, 0] / 2,
                           centers[:, 0] - whs[:, 1] / 2,
                           centers[:, 1] + whs[:, 0] / 2,
                           centers[:, 0] + whs[:, 1] / 2], dim=-1)
    if clip:
        anchors = torch.clamp(anchors, 0.0, 1.0)
    return anchors[None].to(device)


def _anchor_geometry(anchors):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    return aw, ah, acx, acy


@register("MultiBoxTarget", aliases=("multibox_target",))
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1, negative_mining_ratio=-1,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground truth and encode the regression targets
    (reference: multibox_target.cc).  ``anchor`` (1, N, 4) corners,
    ``label`` (B, M, 5) rows [cls, xmin, ymin, xmax, ymax] padded with
    cls -1, ``cls_pred`` (B, C, N); returns (loc_target (B, N*4), loc_mask
    (B, N*4), cls_target (B, N)).

    Each valid gt also claims its best anchor (the force-match).  As in
    the JAX op, a padded gt's best anchor is index 0 too, the claim is a
    max over the gts that name an anchor, and a claimed anchor takes the
    first gt, padded or not, whose best anchor it is.  Hard-negative
    mining keeps the ``negative_mining_ratio`` x matched candidates with
    the highest foreground score, ties by index; the rest take
    ``ignore_label``.  ``cls_pred`` enters only through that rank."""
    anchors = anchor[0]
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    dev = anchors.device
    var = [float(v) for v in variances]
    gt_valid = label[:, :, 0] >= 0                           # (B, M)
    gt_boxes = label[:, :, 1:5]
    iou = _corner_iou(anchors[None, :, None, :], gt_boxes[:, None, :, :])
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)                               # per anchor
    best_gt = iou.argmax(dim=2)
    matched = best_iou >= overlap_threshold
    best_anchor = iou.argmax(dim=1)                          # (B, M)
    force = torch.zeros(B, N, dtype=torch.int32, device=dev).scatter_reduce(
        1, best_anchor, gt_valid.to(torch.int32), "amax").bool()
    first_gt = torch.full((B, N), M, dtype=torch.int64,
                          device=dev).scatter_reduce(
        1, best_anchor, torch.arange(M, device=dev).expand(B, M), "amin")
    gt_of_anchor = torch.where(force, first_gt, best_gt)
    matched = matched | force
    g = torch.gather(gt_boxes, 1, gt_of_anchor[:, :, None].expand(B, N, 4))
    aw, ah, acx, acy = _anchor_geometry(anchors)
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    aw8 = torch.clamp(aw, min=1e-8)
    ah8 = torch.clamp(ah, min=1e-8)
    loc = torch.stack([(gcx - acx) / aw8 / var[0],
                       (gcy - acy) / ah8 / var[1],
                       torch.log(gw / aw8) / var[2],
                       torch.log(gh / ah8) / var[3]], dim=-1)
    mf = matched.to(loc.dtype)
    loc_mask = mf[:, :, None].expand(B, N, 4).reshape(B, N * 4)
    loc_target = (loc * mf[:, :, None]).reshape(B, N * 4)
    gt_cls = torch.gather(label[:, :, 0], 1, gt_of_anchor)
    cls_target = torch.where(matched, gt_cls + 1.0,
                             torch.zeros_like(gt_cls))
    if negative_mining_ratio > 0:
        pred = cls_pred
        max_fg = pred[:, 1:].max(dim=1).values if pred.shape[1] > 1 \
            else pred[:, 0]
        neg_cand = ~matched & (best_iou < negative_mining_thresh)
        num_neg = torch.clamp(matched.sum(dim=1, keepdim=True)
                              * negative_mining_ratio,
                              min=minimum_negative_samples)
        negness = torch.where(neg_cand, max_fg, float("-inf"))
        # the rank of each anchor in the stable descending order: the
        # inverse of the sorting permutation (argsort of argsort)
        order = torch.argsort(-negness, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=dev).expand(B, N))
        selected = neg_cand & (rank < num_neg)
        cls_target = torch.where(
            matched, cls_target,
            torch.where(selected, torch.zeros_like(cls_target),
                        torch.full_like(cls_target, float(ignore_label))))
    return loc_target, loc_mask, cls_target


@register("MultiBoxDetection", aliases=("multibox_detection",))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode predictions into detections, then NMS (reference:
    multibox_detection.cc): (B, N, 6) rows [id, score, xmin, ymin, xmax,
    ymax] sorted by score, id -1 on a dropped row."""
    anchors = anchor[0]
    var = [float(v) for v in variances]
    B, C, N = cls_prob.shape
    loc = loc_pred.reshape(B, N, 4)
    aw, ah, acx, acy = _anchor_geometry(anchors)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1) \
        if C > 1 else cls_prob
    score = fg.amax(dim=1)
    cls_id = fg.argmax(dim=1).to(cls_prob.dtype)
    keep = score > threshold
    minus = torch.full_like(score, -1.0)
    det = torch.cat([torch.where(keep, cls_id, minus)[..., None],
                     torch.where(keep, score, minus)[..., None], boxes],
                    dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


# ROIs a chunk of ROIPooling: bounds the (chunk, C, H, W) masked copies
_ROI_CHUNK_ELEMS = 1 << 26


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max ROI pooling (reference: src/operator/roi_pooling.cc): ``data``
    (B, C, H, W), ``rois`` (R, 5) [batch_idx, x1, y1, x2, y2] in input
    pixels -> (R, C, PH, PW).  The corners round half to even
    (``torch.round``, as ``jnp.round``); bin edges floor and ceil on
    integers; an empty bin gives 0.  Each bin's max is taken over its
    columns, then over its rows."""
    PH, PW = (int(p) for p in pooled_size)
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).to(torch.int64)
                      for i in range(1, 5))
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    py = torch.arange(PH, device=dev)
    px = torch.arange(PW, device=dev)
    hs = y1[:, None] + _floor_div(py[None] * rh[:, None], PH)
    he = y1[:, None] - _floor_div(-(py[None] + 1) * rh[:, None], PH)
    ws = x1[:, None] + _floor_div(px[None] * rw[:, None], PW)
    we = x1[:, None] - _floor_div(-(px[None] + 1) * rw[:, None], PW)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    ymask = (ys[None, None] >= hs[:, :, None]) & (ys < he[:, :, None])
    xmask = (xs[None, None] >= ws[:, :, None]) & (xs < we[:, :, None])
    chunk = max(1, _ROI_CHUNK_ELEMS // max(1, C * H * W))
    outs = []
    for r0 in range(0, R, chunk):
        sl = slice(r0, r0 + chunk)
        img = data[b[sl]]                                     # (r, C, H, W)
        cols = torch.stack([
            torch.where(xmask[sl, j, None, None, :], img,
                        float("-inf")).amax(3)
            for j in range(PW)], dim=-1)                      # (r, C, H, PW)
        cells = torch.stack([
            torch.where(ymask[sl, i, None, :, None], cols,
                        float("-inf")).amax(2)
            for i in range(PH)], dim=2)                       # (r, C, PH, PW)
        outs.append(torch.where(torch.isfinite(cells), cells, 0.0))
    if not outs:
        return data.new_zeros(0, C, PH, PW)
    return torch.cat(outs, dim=0)


@register("_contrib_ROIAlign", aliases=("roi_align", "ROIAlign"))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """Bilinear ROI align (reference: roi_align.cc, Mask R-CNN): each bin
    averages ``sample_ratio``^2 bilinear samples.  The taps clamp to the
    map.  ``aligned`` shifts the corners by -0.5 pixel and lets an ROI be
    smaller than one pixel."""
    PH, PW = (int(p) for p in pooled_size)
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    offset = 0.5 if aligned else 0.0
    sr = max(int(sample_ratio), 1)
    b = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    least = 1e-8 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=least) / PW
    bin_h = torch.clamp(y2 - y1, min=least) / PH
    frac = (torch.arange(sr, device=dev, dtype=dt) + 0.5) / sr
    ty = (torch.arange(PH, device=dev, dtype=dt)[:, None] + frac).reshape(-1)
    tx = (torch.arange(PW, device=dev, dtype=dt)[:, None] + frac).reshape(-1)
    y = torch.clamp(y1[:, None] + ty[None] * bin_h[:, None], 0.0, H - 1.0)
    x = torch.clamp(x1[:, None] + tx[None] * bin_w[:, None], 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)                        # (R, PH*sr)
    x0 = torch.floor(x).to(torch.int64)                        # (R, PW*sr)
    yb = torch.clamp(y0 + 1, max=H - 1)
    xb = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0.to(dt))[:, :, None, None]
    wx = (x - x0.to(dt))[:, None, :, None]
    rows = data.permute(0, 2, 3, 1).reshape(B * H * W, C)

    def tap(yi, xi):
        lin = (b[:, None, None] * H + yi[:, :, None]) * W + xi[:, None, :]
        return rows[lin]                                 # (R, PH*sr, PW*sr, C)

    v = (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(yb, x0) * wy * (1 - wx)
         + tap(y0, xb) * (1 - wy) * wx + tap(yb, xb) * wy * wx)
    v = v.reshape(R, PH, sr, PW, sr, C).sum(dim=(2, 4)) / (sr * sr)
    return v.permute(0, 3, 1, 2)
