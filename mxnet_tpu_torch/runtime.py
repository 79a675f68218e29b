"""Runtime feature detection.

Counterpart of ``mxnet_tpu/runtime.py`` (reference: src/libinfo.cc +
python/mxnet/runtime.py): ``Features()`` / ``feature_list()`` report what
this build and host support, under the reference's keys, each probed:
``CUDA``, ``CUDNN`` and ``NCCL`` from torch; ``TPU``, ``XLA`` and
``ICI_COLLECTIVES`` False.  The ``PALLAS`` slot, the JAX package's flag
for its hand-written TPU kernels, is the port's flag for its hand-written
Hopper kernels: true only while ``_kernels`` holds every library of
``_kernels.SOURCES`` built and loaded, read at each look.  Probing
initialises no CUDA context.
"""

from __future__ import annotations


class Feature:
    """One feature; ``enabled`` is a value, or a probe read at each look."""

    __slots__ = ("name", "_value")

    def __init__(self, name, enabled):
        self.name = name
        self._value = enabled

    @property
    def enabled(self):
        return bool(self._value() if callable(self._value) else self._value)

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _has_native_jpeg():
    try:
        from . import _native

        return _native.has_jpeg()
    except Exception:
        return False


def _cuda():
    import torch

    return torch.cuda.is_available()


def _cudnn():
    import torch

    return _cuda() and torch.backends.cudnn.is_available()


def _nccl():
    import torch.distributed as dist

    return _cuda() and dist.is_available() and dist.is_nccl_available()


def _hopper_kernels():
    from . import _kernels

    return set(_kernels.SOURCES) <= set(_kernels._LIBS)


def _detect():
    import torch

    feats = {
        # accelerator backends (reference: CUDA/CUDNN/TENSORRT slots)
        "TPU": False,
        "XLA": False,
        "PALLAS": _hopper_kernels,
        "CUDA": _cuda(),
        "CUDNN": _cudnn(),
        "NCCL": _nccl(),
        "TENSORRT": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        # numeric
        "F16C": True,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        # IO / formats
        "OPENCV": False,       # PIL-based codecs instead
        # the native libjpeg decode+augment library, probed when built
        "JPEG_TURBO": _has_native_jpeg(),
        "RECORDIO": True,
        # distributed
        "DIST_KVSTORE": torch.distributed.is_available(),
        "PS_LITE": False,
        "ICI_COLLECTIVES": False,
        # language/runtime
        "SIGNAL_HANDLER": False,
        "DEBUG": False,
        "PROFILER": True,
    }
    return {name: Feature(name, on) for name, on in feats.items()}


class Features(dict):
    """Dict of Feature (reference: mx.runtime.Features)."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            dict.__init__(cls.instance, _detect())
        return cls.instance

    def __init__(self):
        pass

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature '{feature_name}' is unknown, "
                               "known features are: "
                               f"{list(self.keys())}")
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
