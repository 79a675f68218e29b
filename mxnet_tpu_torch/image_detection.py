"""The detection image pipeline: the ``Det*Aug`` augmenters,
``CreateDetAugmenter`` and ``ImageDetIter``.

Counterpart of ``mxnet_tpu/image_detection.py`` (reference:
python/mxnet/image/detection.py), the input path of SSD and Faster R-CNN
training.  Preprocessing is numpy on the host, as in ``image``: a
sample's augmenters run under ``with cpu():``, so an image augmenter
borrowed from ``image`` (``DetBorrowAug``) keeps its result on the host,
and each batch goes to the caller's context (the card by default) in one
``from_host`` copy of the data and one of the labels.  Labels are the
reference's packed rows ``[header_width, object_width, (header extras),
obj0 (cls, xmin, ymin, xmax, ymax, extras...), obj1, ...]`` with
coordinates in [0, 1]; a batch pads its object axis with -1 rows, which
``MultiBoxTarget`` reads as no object.  Random draws come from numpy's
global generator, as in the JAX package.
"""

from __future__ import annotations

import json

import numpy as _np

from .base import MXNetError
from .image import (BrightnessJitterAug, CastAug, ColorNormalizeAug,
                    ContrastJitterAug, ForceResizeAug, HueJitterAug,
                    ImageIter, LightingAug, RandomGrayAug, ResizeAug,
                    SaturationJitterAug, SequentialAug, _to_np)


class DetAugmenter:
    """Detection augmenter: __call__(src, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(),
                           self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter; label passes through (reference:
    DetBorrowAug)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter (or none with skip_prob)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _np.random.rand() < self.skip_prob or not self.aug_list:
            return src, label
        aug = self.aug_list[_np.random.randint(len(self.aug_list))]
        return aug(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and box x-coordinates with probability p."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _np.random.rand() < self.p:
            arr = _to_np(src)[:, ::-1]
            label = label.copy()
            tmp = 1.0 - label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
            return arr, label
        return _to_np(src), label


def _box_iou_coverage(crop, boxes):
    """Fraction of each box's area inside `crop` (x0, y0, x1, y1)."""
    ix0 = _np.maximum(boxes[:, 1], crop[0])
    iy0 = _np.maximum(boxes[:, 2], crop[1])
    ix1 = _np.minimum(boxes[:, 3], crop[2])
    iy1 = _np.minimum(boxes[:, 4], crop[3])
    iw = _np.maximum(ix1 - ix0, 0)
    ih = _np.maximum(iy1 - iy0, 0)
    inter = iw * ih
    area = _np.maximum((boxes[:, 3] - boxes[:, 1])
                       * (boxes[:, 4] - boxes[:, 2]), 1e-12)
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop (reference: DetRandomCropAug): sample a
    crop whose min-object-coverage constraint holds; boxes are clipped
    and re-normalized, under-covered objects ejected."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ratio = _np.random.uniform(*self.aspect_ratio_range)
            w = min(_np.sqrt(area * ratio), 1.0)
            h = min(_np.sqrt(area / ratio), 1.0)
            x0 = _np.random.uniform(0, 1 - w)
            y0 = _np.random.uniform(0, 1 - h)
            crop = (x0, y0, x0 + w, y0 + h)
            if label.size == 0:
                return crop, None
            cov = _box_iou_coverage(crop, label)
            # reference semantics: EVERY object intersecting the crop
            # must be covered >= min_object_covered (amin over
            # intersecting boxes) — a crop may exclude an object
            # entirely, but not truncate one below the constraint
            inter = cov > 0
            if inter.any() and cov[inter].min() >= self.min_object_covered:
                return crop, cov
        return None, None

    def __call__(self, src, label):
        arr = _to_np(src)
        crop, cov = self._sample_crop(label)
        if crop is None:
            return arr, label
        x0, y0, x1, y1 = crop
        hgt, wid = arr.shape[:2]
        px0, py0 = int(x0 * wid), int(y0 * hgt)
        px1, py1 = max(int(x1 * wid), px0 + 1), max(int(y1 * hgt),
                                                    py0 + 1)
        out = arr[py0:py1, px0:px1]
        if label.size == 0:
            return out, label
        keep = cov >= self.min_eject_coverage
        new = label[keep].copy()
        w, h = x1 - x0, y1 - y0
        new[:, 1] = _np.clip((new[:, 1] - x0) / w, 0, 1)
        new[:, 2] = _np.clip((new[:, 2] - y0) / h, 0, 1)
        new[:, 3] = _np.clip((new[:, 3] - x0) / w, 0, 1)
        new[:, 4] = _np.clip((new[:, 4] - y0) / h, 0, 1)
        return out, new


class DetRandomPadAug(DetAugmenter):
    """Random expansion pad (reference: DetRandomPadAug): place the
    image inside a larger canvas, rescale boxes."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _to_np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ratio = _np.random.uniform(*self.aspect_ratio_range)
            nw = _np.sqrt(area * ratio)
            nh = _np.sqrt(area / ratio)
            if nw < 1 or nh < 1:
                continue
            pw, ph = int(w * nw), int(h * nh)
            x0 = _np.random.randint(0, pw - w + 1)
            y0 = _np.random.randint(0, ph - h + 1)
            canvas = _np.empty((ph, pw, arr.shape[2]), arr.dtype)
            canvas[...] = _np.asarray(self.pad_val, arr.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = arr
            if label.size:
                label = label.copy()
                label[:, 1] = (label[:, 1] * w + x0) / pw
                label[:, 2] = (label[:, 2] * h + y0) / ph
                label[:, 3] = (label[:, 3] * w + x0) / pw
                label[:, 4] = (label[:, 4] * h + y0) / ph
            return canvas, label
        return arr, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Reference: mx.image.CreateDetAugmenter — the SSD default
    pipeline."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(area_range[1], 1.0)),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    jitters = []
    if brightness:
        jitters.append(BrightnessJitterAug(brightness))
    if contrast:
        jitters.append(ContrastJitterAug(contrast))
    if saturation:
        jitters.append(SaturationJitterAug(saturation))
    if hue:
        jitters.append(HueJitterAug(hue))
    if jitters:
        auglist.append(DetBorrowAug(SequentialAug(jitters)))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(
            LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator (reference: mx.image.ImageDetIter): labels are
    variable-object packed rows; batches emit (B, max_objects,
    object_width) with -1 padding."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, label_name="label", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape=(3,)
                                          + tuple(data_shape)[1:])
        self._label_name = label_name
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=aug_list, **kwargs)
        # scan labels once for (max_objects, object_width)
        self._obj_width = None
        max_obj = 1
        for idx, (kind, item) in enumerate(self._items):
            lab = self._raw_label(kind, item)
            objs = self._parse_label(lab)
            max_obj = max(max_obj, objs.shape[0])
            if objs.size:
                if self._obj_width is None:
                    self._obj_width = objs.shape[1]
                elif objs.shape[1] != self._obj_width:
                    raise MXNetError(
                        f"ImageDetIter: record {idx} has object width "
                        f"{objs.shape[1]} but the dataset started with "
                        f"{self._obj_width} — mixed widths cannot batch")
        self._obj_width = self._obj_width or 5
        self._max_obj = max_obj

    def _raw_label(self, kind, item):
        from . import recordio as rio

        if kind == "rec":
            header, _ = rio.unpack(item)
            return _np.asarray(header.label, _np.float32)
        return _np.asarray(item[1], _np.float32)

    @staticmethod
    def _parse_label(raw):
        """Packed [hw, ow, (hw-2 extras), obj...] -> (N, ow) array."""
        raw = _np.asarray(raw, _np.float32).ravel()
        if raw.size < 2:
            raise MXNetError("ImageDetIter: label too short for the "
                             "packed detection format")
        hw = int(raw[0])
        ow = int(raw[1])
        if hw < 2 or hw > raw.size:
            raise MXNetError(
                f"ImageDetIter: header width {hw} invalid for a "
                f"{raw.size}-value packed label (must be in [2, size])")
        if ow < 5:
            raise MXNetError(f"ImageDetIter: object width {ow} < 5")
        body = raw[hw:]
        if body.size % ow:
            raise MXNetError(
                f"ImageDetIter: label body of {body.size} values is not "
                f"a multiple of object width {ow} (malformed packed "
                "label)")
        return body.reshape(-1, ow)

    @property
    def provide_label(self):
        from .io import DataDesc

        return [DataDesc(self._label_name,
                         (self.batch_size, self._max_obj,
                          self._obj_width))]

    def next(self):
        from .context import cpu, current_context
        from .io import DataBatch
        from . import recordio as rio
        from .image import imdecode_np, imread, _to_np as to_np
        from .ndarray.ndarray import from_host

        if self.cur + self.batch_size > len(self._items):
            raise StopIteration
        c, h, w = self.data_shape
        data = _np.empty((self.batch_size, c, h, w), _np.float32)
        label = _np.full((self.batch_size, self._max_obj,
                          self._obj_width), -1.0, _np.float32)
        for i in range(self.batch_size):
            kind, item = self._items[self._order[self.cur + i]]
            if kind == "rec":
                header, payload = rio.unpack(item)
                img = imdecode_np(payload)
                lab = _np.asarray(header.label, _np.float32)
            else:
                path, lab = item
                img = to_np(imread(path))
                lab = _np.asarray(lab, _np.float32)
            objs = self._parse_label(lab)
            with cpu():
                for aug in self.auglist:
                    img, objs = aug(img, objs)
            arr = to_np(img).astype(_np.float32)
            data[i] = arr.transpose(2, 0, 1)
            n = min(objs.shape[0], self._max_obj)
            if n:
                label[i, :n] = objs[:n]
        self.cur += self.batch_size
        ctx = current_context()
        return DataBatch(data=[from_host(data, ctx, own=True)],
                         label=[from_host(label, ctx, own=True)], pad=0)
