"""ctypes loader for the native C++ input libraries.

Counterpart of ``mxnet_tpu/_native.py`` (reference: python/mxnet/base.py's
``_LIB`` dll loading), kept as the port's own copy: ``src/libmxtpu_io.so``
(the RecordIO codec and the threaded record prefetcher) and
``src/libmxtpu_img.so`` (batched libjpeg decode and augment), both built
by ``make -C src`` and loaded independently.  Neither depends on a
framework, and ``available()`` only says whether the codec library
loaded: it decides nothing about the device.  Every consumer has a pure
Python fallback, so an unbuilt tree still works.
"""

from __future__ import annotations

import ctypes
import os

_LIB = None
_TRIED = False


def lib():
    """Return the loaded native library or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(here, "src", "libmxtpu_io.so"),
        os.path.join(here, "libmxtpu_io.so"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                _LIB = ctypes.CDLL(path)
                _declare(_LIB)
                break
            except OSError:
                _LIB = None
    return _LIB


def _declare(L):
    c = ctypes
    L.mxtpu_recio_open_read.restype = c.c_void_p
    L.mxtpu_recio_open_read.argtypes = [c.c_char_p]
    L.mxtpu_recio_close_read.argtypes = [c.c_void_p]
    L.mxtpu_recio_scan.restype = c.c_int64
    L.mxtpu_recio_scan.argtypes = [c.c_void_p,
                                   c.POINTER(c.POINTER(c.c_int64))]
    L.mxtpu_recio_read_at.restype = c.c_int64
    L.mxtpu_recio_read_at.argtypes = [c.c_void_p, c.c_int64,
                                      c.POINTER(c.POINTER(c.c_char))]
    L.mxtpu_free.argtypes = [c.POINTER(c.c_char)]
    L.mxtpu_free_i64.argtypes = [c.POINTER(c.c_int64)]
    L.mxtpu_recio_open_write.restype = c.c_void_p
    L.mxtpu_recio_open_write.argtypes = [c.c_char_p, c.c_int]
    L.mxtpu_recio_write.restype = c.c_int64
    L.mxtpu_recio_write.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    L.mxtpu_recio_close_write.argtypes = [c.c_void_p]
    L.mxtpu_prefetcher_create.restype = c.c_void_p
    L.mxtpu_prefetcher_create.argtypes = [c.c_char_p, c.c_int, c.c_int,
                                          c.c_uint64]
    L.mxtpu_prefetcher_size.restype = c.c_int64
    L.mxtpu_prefetcher_size.argtypes = [c.c_void_p]
    L.mxtpu_prefetcher_next.restype = c.c_int64
    L.mxtpu_prefetcher_next.argtypes = [c.c_void_p,
                                        c.POINTER(c.POINTER(c.c_char))]
    L.mxtpu_prefetcher_reset.argtypes = [c.c_void_p, c.c_uint64]
    L.mxtpu_prefetcher_destroy.argtypes = [c.c_void_p]


class NativeRecordReader:
    """Random-access reader over the native codec."""

    def __init__(self, path):
        L = lib()
        if L is None:
            raise OSError("native library not built (make -C src)")
        self._L = L
        self._h = L.mxtpu_recio_open_read(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def scan(self):
        ptr = ctypes.POINTER(ctypes.c_int64)()
        n = self._L.mxtpu_recio_scan(self._h, ctypes.byref(ptr))
        if n < 0:
            raise OSError("corrupt record file")
        out = [ptr[i] for i in range(n)]
        self._L.mxtpu_free_i64(ptr)
        return out

    def read_at(self, offset):
        ptr = ctypes.POINTER(ctypes.c_char)()
        n = self._L.mxtpu_recio_read_at(self._h, offset,
                                        ctypes.byref(ptr))
        if n < 0:
            raise OSError("read failed")
        data = ctypes.string_at(ptr, n)
        self._L.mxtpu_free(ptr)
        return data

    def close(self):
        if self._h:
            self._L.mxtpu_recio_close_read(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeRecordWriter:
    def __init__(self, path, append=False):
        L = lib()
        if L is None:
            raise OSError("native library not built (make -C src)")
        self._L = L
        self._h = L.mxtpu_recio_open_write(path.encode(),
                                           1 if append else 0)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write(self, data):
        return self._L.mxtpu_recio_write(self._h, data, len(data))

    def close(self):
        if self._h:
            self._L.mxtpu_recio_close_write(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePrefetcher:
    """Threaded record prefetcher (dmlc::ThreadedIter analog)."""

    def __init__(self, path, n_threads=4, shuffle=False, seed=0):
        L = lib()
        if L is None:
            raise OSError("native library not built (make -C src)")
        self._L = L
        self._h = L.mxtpu_prefetcher_create(path.encode(), n_threads,
                                            1 if shuffle else 0, seed)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def __len__(self):
        return self._L.mxtpu_prefetcher_size(self._h)

    def next(self):
        ptr = ctypes.POINTER(ctypes.c_char)()
        n = self._L.mxtpu_prefetcher_next(self._h, ctypes.byref(ptr))
        if n < 0:
            return None
        data = ctypes.string_at(ptr, n)
        self._L.mxtpu_free(ptr)
        return data

    def reset(self, seed=0):
        self._L.mxtpu_prefetcher_reset(self._h, seed)

    def close(self):
        if self._h:
            self._L.mxtpu_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def available():
    return lib() is not None


# libmxtpu_img.so loads independently: a host without libjpeg keeps the
# recordio/prefetch fast path
_IMG_LIB = None
_IMG_TRIED = False


def img_lib():
    global _IMG_LIB, _IMG_TRIED
    if _IMG_TRIED:
        return _IMG_LIB
    _IMG_TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in (os.path.join(here, "src", "libmxtpu_img.so"),
                 os.path.join(here, "libmxtpu_img.so")):
        if os.path.exists(path):
            try:
                L = ctypes.CDLL(path)
                c = ctypes
                L.MXTPUHasJpeg.restype = c.c_int
                L.MXTPUImageDecodeAugment.restype = c.c_int
                L.MXTPUImageDecodeAugment.argtypes = [
                    c.POINTER(c.c_char_p), c.POINTER(c.c_size_t),
                    c.c_int, c.c_int, c.c_int, c.c_int,
                    c.POINTER(c.c_int32), c.POINTER(c.c_uint64),
                    c.POINTER(c.c_uint8), c.c_float,
                    c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int,
                    c.POINTER(c.c_float), c.POINTER(c.c_int32)]
                _IMG_LIB = L
                break
            except OSError:
                _IMG_LIB = None
    return _IMG_LIB


def has_jpeg():
    L = img_lib()
    return bool(L is not None and L.MXTPUHasJpeg())


def decode_augment_batch(payloads, out, resize_short=-1, crop_modes=None,
                         seeds=None, mirror=None, scale=1.0, mean=None,
                         std=None, n_threads=4):
    """Batch JPEG decode + augment into ``out`` (N, 3, H, W) float32.

    Reference: iter_image_recordio_2.cc's threaded decode+augment loop.
    crop_modes per image: -1 center, -2 random (seeded by seeds).
    Returns a numpy int32 status array (1 decoded, 0 = caller must fall
    back, e.g. PNG payloads).
    """
    import numpy as np

    L = img_lib()
    if L is None:
        raise OSError("native jpeg path not built (make -C src)")
    n = len(payloads)
    # hard checks, not asserts: a shape mismatch here is an
    # out-of-bounds C write, and python -O strips asserts
    if not (out.ndim == 4 and out.shape[0] == n and out.shape[1] == 3
            and out.dtype == np.float32 and out.flags.c_contiguous):
        raise ValueError(
            f"out must be C-contiguous float32 (n={n}, 3, H, W); got "
            f"{out.dtype} {out.shape}")
    c = ctypes
    # bytes are immutable: pass their buffers by pointer, no copy (the
    # payloads list keeps them alive for this synchronous call)
    payloads = [bytes(p) for p in payloads]
    ptrs = (c.c_char_p * n)(*payloads)
    sizes = (c.c_size_t * n)(*[len(p) for p in payloads])
    cm = np.full(n, -1, np.int32) if crop_modes is None \
        else np.asarray(crop_modes, np.int32)
    sd = np.zeros(n, np.uint64) if seeds is None \
        else np.asarray(seeds, np.uint64)
    mr = np.zeros(n, np.uint8) if mirror is None \
        else np.asarray(mirror, np.uint8)
    mean = np.asarray(mean if mean is not None else [0, 0, 0],
                      np.float32)
    std = np.asarray(std if std is not None else [1, 1, 1], np.float32)
    status = np.zeros(n, np.int32)
    L.MXTPUImageDecodeAugment(
        ptrs, sizes, n, int(resize_short), int(out.shape[2]),
        int(out.shape[3]),
        cm.ctypes.data_as(c.POINTER(c.c_int32)),
        sd.ctypes.data_as(c.POINTER(c.c_uint64)),
        mr.ctypes.data_as(c.POINTER(c.c_uint8)),
        float(scale), mean.ctypes.data_as(c.POINTER(c.c_float)),
        std.ctypes.data_as(c.POINTER(c.c_float)), int(n_threads),
        out.ctypes.data_as(c.POINTER(c.c_float)),
        status.ctypes.data_as(c.POINTER(c.c_int32)))
    return status
