"""Vision transforms.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py`` (reference:
python/mxnet/gluon/data/vision/transforms.py): Compose, Cast, ToTensor,
Normalize, RandomResizedCrop, CenterCrop, Resize, CropResize,
RandomFlipLeftRight/TopBottom, RandomBrightness/Contrast/Saturation/Hue/
ColorJitter/Lighting.

Each transform is a ``Block`` of the port's Gluon core: ``Cast``,
``ToTensor`` and ``Normalize`` are ``HybridBlock``s whose
``hybrid_forward`` runs on the input's device; the geometric and colour
transforms run on the host (PIL and numpy, as the reference's do) and
return an NDArray on the current context.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as _np
import torch

from ...block import Block, HybridBlock
from ...nn import HybridSequential, Sequential
from ....ndarray.ndarray import NDArray, from_host


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def _to_nd(x):
    return from_host(x)


class Compose(Sequential):
    """Sequentially composes transforms (reference: transforms.Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for i in transforms:
            self.add(i)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference:
    transforms.ToTensor)."""

    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        out = F.cast(x, dtype="float32") / 255.0
        if out.ndim == 3:
            return F.transpose(out, axes=(2, 0, 1))
        return F.transpose(out, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):
    """(x - mean) / std per channel of a CHW tensor."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = torch.as_tensor(self._mean, dtype=torch.float32,
                               device=x.device)
        std = torch.as_tensor(self._std, dtype=torch.float32,
                              device=x.device)
        nd = x.ndim
        if mean.ndim == 1:
            shape = [1] * nd
            shape[-3] = mean.shape[0]
            mean = mean.reshape(shape)
        if std.ndim == 1:
            shape = [1] * nd
            shape[-3] = std.shape[0]
            std = std.reshape(shape)
        return (x - mean) / std


class _HostTransform(Block):
    """Base for host-side (PIL/numpy) image transforms."""

    def forward(self, x):
        return _to_nd(self._apply(_to_np(x)))

    def _apply(self, arr):
        raise NotImplementedError


class Resize(_HostTransform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def _apply(self, arr):
        from .... import image

        if isinstance(self._size, int):
            if self._keep:
                return image.resize_short_np(arr, self._size,
                                             self._interpolation)
            return image.imresize_np(arr, self._size, self._size,
                                     self._interpolation)
        w, h = self._size
        return image.imresize_np(arr, w, h, self._interpolation)


class CenterCrop(_HostTransform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size,
                                                                   size)
        self._interpolation = interpolation

    def _apply(self, arr):
        from .... import image

        return image.center_crop_np(arr, self._size, self._interpolation)


class CropResize(_HostTransform):
    """Crop the fixed region (x, y, w, h) then optionally resize to
    ``size`` (reference: transforms.CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._box = (int(x), int(y), int(width), int(height))
        if size is not None and not isinstance(size, (tuple, list)):
            size = (size, size)
        self._size = tuple(size) if size is not None else None
        self._interpolation = interpolation

    def _apply(self, arr):
        from .... import image

        x, y, w, h = self._box
        return image.fixed_crop_np(arr, x, y, w, h, size=self._size,
                                   interp=self._interpolation)


class RandomResizedCrop(_HostTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size,
                                                                   size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def _apply(self, arr):
        from .... import image

        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            log_ratio = (_np.log(self._ratio[0]), _np.log(self._ratio[1]))
            aspect = _np.exp(_pyrandom.uniform(*log_ratio))
            new_w = int(round(_np.sqrt(target_area * aspect)))
            new_h = int(round(_np.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h:
                x0 = _pyrandom.randint(0, w - new_w)
                y0 = _pyrandom.randint(0, h - new_h)
                return image.fixed_crop_np(arr, x0, y0, new_w, new_h,
                                           self._size, self._interpolation)
        return image.center_crop_np(arr, self._size, self._interpolation)


class RandomFlipLeftRight(_HostTransform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def _apply(self, arr):
        if _pyrandom.random() < self._p:
            return arr[:, ::-1, :].copy()
        return arr


class RandomFlipTopBottom(_HostTransform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def _apply(self, arr):
        if _pyrandom.random() < self._p:
            return arr[::-1, :, :].copy()
        return arr


class RandomBrightness(_HostTransform):
    def __init__(self, brightness):
        super().__init__()
        self._brightness = brightness

    def _apply(self, arr):
        alpha = 1.0 + _pyrandom.uniform(-self._brightness, self._brightness)
        return _np.clip(arr.astype(_np.float32) * alpha, 0, 255)


class RandomContrast(_HostTransform):
    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def _apply(self, arr):
        alpha = 1.0 + _pyrandom.uniform(-self._contrast, self._contrast)
        arr = arr.astype(_np.float32)
        gray = (arr * _np.array([[[0.299, 0.587, 0.114]]])).sum(
            axis=2, keepdims=True)
        return _np.clip(arr * alpha + gray.mean() * (1 - alpha), 0, 255)


class RandomSaturation(_HostTransform):
    def __init__(self, saturation):
        super().__init__()
        self._saturation = saturation

    def _apply(self, arr):
        alpha = 1.0 + _pyrandom.uniform(-self._saturation,
                                        self._saturation)
        arr = arr.astype(_np.float32)
        gray = (arr * _np.array([[[0.299, 0.587, 0.114]]])).sum(
            axis=2, keepdims=True)
        return _np.clip(arr * alpha + gray * (1 - alpha), 0, 255)


class RandomHue(_HostTransform):
    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def _apply(self, arr):
        alpha = _pyrandom.uniform(-self._hue, self._hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]])
        tyiq = _np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]])
        ityiq = _np.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]])
        t = ityiq @ bt @ tyiq
        return _np.clip(arr.astype(_np.float32) @ t.T, 0, 255)


class RandomColorJitter(_HostTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def _apply(self, arr):
        order = list(self._transforms)
        _pyrandom.shuffle(order)
        for t in order:
            arr = t._apply(arr)
        return arr


class RandomLighting(_HostTransform):
    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha
        self._eigval = _np.array([55.46, 4.794, 1.148])
        self._eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                                  [-0.5808, -0.0045, -0.814],
                                  [-0.5836, -0.6948, 0.4203]])

    def _apply(self, arr):
        alpha = _np.random.normal(0, self._alpha, size=(3,))
        rgb = _np.dot(self._eigvec * alpha, self._eigval)
        return arr.astype(_np.float32) + rgb
