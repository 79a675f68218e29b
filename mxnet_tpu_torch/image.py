"""Image loading and augmentation.

Counterpart of ``mxnet_tpu/image.py`` (reference:
python/mxnet/image/image.py): imdecode, imread, imresize, resize_short,
center_crop, random_crop, fixed_crop, color_normalize, the
``Augmenter``s, CreateAugmenter and ImageIter.  The reference decodes
with OpenCV; here PIL does the codec work on the host (imported when a
codec is needed, so the module loads without it) and numpy does the
geometry.

Functions with the ``_np`` suffix operate on host numpy HWC uint8 arrays
(used inside data pipelines before the copy to the device); the public
API without the suffix returns NDArrays on the caller's context
(``current_context()``).  The detection pipeline (``ImageDetIter``,
``CreateDetAugmenter`` and the ``Det*Aug`` augmenters) lives in
``image_detection`` and is re-exported here, as in the JAX package.
"""

from __future__ import annotations

import io as _io
import os
import random as _pyrandom

import numpy as _np

from .base import MXNetError
from .ndarray.ndarray import NDArray, from_host


def _to_nd(np_arr):
    """A host array as an NDArray on the caller's context."""
    return from_host(np_arr)


def _to_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return _np.asarray(img)


# -- codecs --------------------------------------------------------------------

def imdecode_np(buf, iscolor=1):
    """Decode compressed image bytes → HWC uint8 numpy (RGB order, matching
    the reference's default to_rgb=1)."""
    from PIL import Image

    img = Image.open(_io.BytesIO(bytes(buf)))
    if iscolor == 0:
        img = img.convert("L")
        arr = _np.asarray(img)
        return arr[:, :, None]
    img = img.convert("RGB")
    return _np.asarray(img)


def imencode(arr, quality=95, img_fmt=".jpg"):
    """Encode HWC uint8 numpy → compressed bytes."""
    from PIL import Image

    arr = _to_np(arr).astype(_np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    img = Image.fromarray(arr)
    out = _io.BytesIO()
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}[
        img_fmt.lstrip(".").lower()]
    img.save(out, format=fmt, quality=quality)
    return out.getvalue()


def imdecode(buf, to_rgb=1, flag=1, **kwargs):
    """Reference: mx.image.imdecode → NDArray HWC uint8."""
    return _to_nd(imdecode_np(buf, iscolor=flag))


def imread(filename, flag=1, to_rgb=1):
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


# -- geometry (numpy) ----------------------------------------------------------

def imresize_np(arr, w, h, interp=1):
    from PIL import Image

    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.NEAREST, 4: Image.LANCZOS}.get(interp,
                                                        Image.BILINEAR)
    if arr.dtype != _np.uint8:
        # PIL has no float RGB mode; resize channel-planes in mode 'F'
        arr32 = arr.astype(_np.float32)
        planes = [
            _np.asarray(Image.fromarray(arr32[:, :, c], mode="F")
                        .resize((w, h), resample))
            for c in range(arr32.shape[2])]
        return _np.stack(planes, axis=2)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    out = _np.asarray(img.resize((w, h), resample))
    if squeeze or out.ndim == 2:
        out = out[:, :, None]
    return out


def resize_short_np(arr, size, interp=2):
    h, w = arr.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize_np(arr, new_w, new_h, interp)


def fixed_crop_np(arr, x0, y0, w, h, size=None, interp=2):
    out = arr[y0:y0 + h, x0:x0 + w, :]
    if size is not None and (w, h) != size:
        out = imresize_np(out, size[0], size[1], interp)
    return out


def center_crop_np(arr, size, interp=2):
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop_np(arr, x0, y0, new_w, new_h)
    if (new_w, new_h) != tuple(size):
        out = imresize_np(out, size[0], size[1], interp)
    return out


def random_crop_np(arr, size, interp=2):
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop_np(arr, x0, y0, new_w, new_h)
    if (new_w, new_h) != tuple(size):
        out = imresize_np(out, size[0], size[1], interp)
    return out


# -- NDArray-surface wrappers (reference API) ----------------------------------

def imresize(src, w, h, interp=1):
    return _to_nd(imresize_np(_to_np(src), w, h, interp))


def resize_short(src, size, interp=2):
    return _to_nd(resize_short_np(_to_np(src), size, interp))


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    return _to_nd(fixed_crop_np(_to_np(src), x0, y0, w, h, size, interp))


def center_crop(src, size, interp=2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return (_to_nd(center_crop_np(arr, size, interp)),
            (x0, y0, new_w, new_h))


def random_crop(src, size, interp=2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop_np(arr, x0, y0, new_w, new_h)
    if (new_w, new_h) != tuple(size):
        out = imresize_np(out, size[0], size[1], interp)
    return _to_nd(out), (x0, y0, new_w, new_h)


def normalize_flip_batch_np(batch_hwc, mirror, scale, mean, std, out=None):
    """Batch-level vectorized mirror + cast + scale/mean/std normalize +
    NHWC→NCHW, replacing the per-sample float copies in the record-iter
    python path.

    ``batch_hwc`` is (N, H, W, C) (typically uint8, flipped IN PLACE for
    mirrored rows); ``mirror`` a length-N bool mask (or None); ``mean`` /
    ``std`` float32 arrays broadcastable against (C, 1, 1).  Writes the
    normalized NCHW float32 batch into ``out`` (allocated when None).

    The op sequence — flip on the integer pixels, cast the whole batch to
    float32, then in-place ``*= scale``, ``-= mean``, ``/= std`` — is
    element-wise the same float32 arithmetic as the per-sample reference
    path ``(chw.astype(f32) * scale - mean) / std``, so results are
    bit-identical to it (and to the native decode kernel).
    """
    batch_hwc = _np.asarray(batch_hwc)
    n, hh, ww, cc = batch_hwc.shape
    if mirror is not None:
        mirror = _np.asarray(mirror, dtype=bool)
        if mirror.any():
            batch_hwc[mirror] = batch_hwc[mirror, :, ::-1]
    if out is None:
        out = _np.empty((n, cc, hh, ww), dtype=_np.float32)
    _np.copyto(out, batch_hwc.transpose(0, 3, 1, 2))
    out *= scale
    out -= mean
    out /= std
    return out


def color_normalize(src, mean, std=None):
    src = _to_np(src).astype(_np.float32)
    mean = _to_np(mean) if mean is not None else None
    std = _to_np(std) if std is not None else None
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return _to_nd(src)


# -- augmenter objects (reference: mx.image.Augmenter subclasses) --------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _to_nd(_to_np(src)[:, ::-1, :])
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _to_nd(_to_np(src).astype(self.typ))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return _to_nd(_to_np(src).astype(_np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = _to_np(src).astype(_np.float32)
        coef = _np.array([[[0.299, 0.587, 0.114]]])
        gray = (arr * coef).sum(axis=2, keepdims=True)
        mean = gray.mean()
        return _to_nd(arr * alpha + mean * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = _to_np(src).astype(_np.float32)
        coef = _np.array([[[0.299, 0.587, 0.114]]])
        gray = (arr * coef).sum(axis=2, keepdims=True)
        return _to_nd(arr * alpha + gray * (1.0 - alpha))


class RandomGrayAug(Augmenter):
    """Convert to 3-channel grayscale with probability p (reference:
    mx.image.RandomGrayAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = _np.array([[0.21, 0.21, 0.21],
                              [0.72, 0.72, 0.72],
                              [0.07, 0.07, 0.07]])

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _to_nd(_np.dot(_to_np(src).astype(_np.float32),
                                  self.mat))
        return src


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (reference: mx.image.HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = _np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]])
        self.ityiq = _np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]])
        t = _np.dot(_np.dot(self.ityiq, bt), self.tyiq).T
        arr = _to_np(src).astype(_np.float32)
        return _to_nd(_np.dot(arr, t))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class LightingAug(Augmenter):
    """PCA-based RGB jitter (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return _to_nd(_to_np(src).astype(_np.float32) + rgb)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the reference's default augmenter list (reference:
    mx.image.CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.814],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and len(_np.shape(mean)):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Python-side image iterator over .rec or .lst files (reference:
    mx.image.ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, **kwargs):
        from .io import DataBatch, DataDesc
        from . import recordio as rio

        assert path_imgrec or path_imglist
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._items = []
        if path_imgrec:
            rec = rio.MXRecordIO(path_imgrec, "r")
            while True:
                r = rec.read()
                if r is None:
                    break
                self._items.append(("rec", r))
            rec.close()
        else:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = [float(x) for x in parts[1:-1]]
                    self._items.append(
                        ("file", (os.path.join(path_root, parts[-1]),
                                  label)))
        self.shuffle = shuffle
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape=(3,) + self.data_shape[1:])
        self.auglist = aug_list
        # Split off the maximal suffix of batch-vectorizable augmenters:
        # flip/cast/normalize run once on the whole collated batch instead
        # of per sample (each per-sample call round-trips through an
        # NDArray, i.e. a device transfer per aug per sample).  Flip
        # DECISIONS are still drawn per sample inside the loop so the RNG
        # stream — and therefore every pixel — matches the unsplit path.
        split = len(aug_list)
        while split > 0 and isinstance(
                aug_list[split - 1],
                (HorizontalFlipAug, CastAug, ColorNormalizeAug)):
            split -= 1
        self._aug_head = aug_list[:split]
        self._aug_tail = aug_list[split:]
        self._order = _np.arange(len(self._items))
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        from .io import DataDesc

        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        from .io import DataDesc

        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self._order)
        self.cur = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from .io import DataBatch
        from . import recordio as rio

        if self.cur + self.batch_size > len(self._items):
            raise StopIteration
        c, h, w = self.data_shape
        data = _np.empty((self.batch_size, c, h, w), dtype=_np.float32)
        label = _np.empty((self.batch_size, self.label_width),
                          dtype=_np.float32)
        batch_hwc = None
        mirror = _np.zeros(self.batch_size, dtype=bool)
        for i in range(self.batch_size):
            kind, item = self._items[self._order[self.cur + i]]
            if kind == "rec":
                header, payload = rio.unpack(item)
                img = _to_nd(imdecode_np(payload))
                lab = header.label
            else:
                path, lab = item
                img = imread(path)
            for aug in self._aug_head:
                img = aug(img)
            # draw here, at this sample's position in the pipeline, so the
            # RNG stream matches running the full aug list per sample
            for aug in self._aug_tail:
                if isinstance(aug, HorizontalFlipAug):
                    mirror[i] = _pyrandom.random() < aug.p
            arr = _to_np(img)
            if batch_hwc is None:
                batch_hwc = _np.empty((self.batch_size,) + arr.shape,
                                      arr.dtype)
            batch_hwc[i] = arr
            label[i] = lab if _np.ndim(lab) else [lab] * self.label_width
        batch = batch_hwc
        for aug in self._aug_tail:
            if isinstance(aug, HorizontalFlipAug):
                if mirror.any():
                    batch[mirror] = batch[mirror, :, ::-1]
            elif isinstance(aug, CastAug):
                batch = batch.astype(aug.typ)
            else:  # ColorNormalizeAug — float64 intermediate like
                   # color_normalize, single downcast at the copyto below
                batch = batch.astype(_np.float32)
                if aug.mean is not None:
                    batch = batch - _to_np(aug.mean)
                if aug.std is not None:
                    batch = batch / _to_np(aug.std)
        _np.copyto(data, batch.transpose(0, 3, 1, 2))
        self.cur += self.batch_size
        return DataBatch(
            data=[from_host(data, own=True)],
            label=[from_host(
                label[:, 0] if self.label_width == 1 else label)],
            pad=0)


# the detection pipeline (reference: python/mxnet/image/detection.py),
# imported at the module's end: image_detection imports from this module
from .image_detection import (CreateDetAugmenter, DetAugmenter,  # noqa: E402
                              DetBorrowAug, DetHorizontalFlipAug,
                              DetRandomCropAug, DetRandomPadAug,
                              DetRandomSelectAug, ImageDetIter)
