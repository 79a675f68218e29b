"""Data iterators producing DataBatches.

Counterpart of ``mxnet_tpu/io/io.py`` (reference: python/mxnet/io/io.py —
DataIter, DataDesc, DataBatch, NDArrayIter, ResizeIter, PrefetchingIter —
and the C++ iterators in src/io/: MNISTIter iter_mnist.cc, CSVIter
iter_csv.cc, ImageRecordIter iter_image_recordio_2.cc, LibSVMIter).

Batches are built as host numpy and placed with one copy per array on the
context current where the iterator is driven (``ndarray.from_host``).
PrefetchingIter runs a background thread per child iterator, like
dmlc::ThreadedIter; the threads run under the context current when it
was built, and place each batch ahead of the step
(``gluon.data.prefetcher.place``) unless ``MXTPU_DEVICE_PREFETCH=0``.
``LibSVMIter`` yields CSR batches (``ndarray.sparse.CSRNDArray``), or
dense ones with ``stype="default"``.
"""

from __future__ import annotations

import gzip
import os
import struct
import threading
from collections import namedtuple

import numpy as _np

from .. import resilience
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray, from_host


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data descriptor with dtype/layout (reference: io.DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype}," \
               f"{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference: io.DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return f"{self.__class__.__name__}: data shapes: {data_shapes} " \
               f"label shapes: {label_shapes}"


class DataIter:
    """Base iterator (reference: io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ResizeIter(DataIter):
    """Resize another iterator to `size` batches per epoch (reference:
    io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iters (reference:
    io.PrefetchingIter; C++ analog: PrefetcherIter/dmlc::ThreadedIter)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        # a context is thread-local: the threads run under the caller's
        ctx = current_context()

        def prefetch_func(self, i):
            # device placement happens HERE, on the prefetch thread, so
            # the copy of batch N+1 overlaps the step on batch N
            # (MXTPU_DEVICE_PREFETCH=0 keeps batches as produced)
            from ..gluon.data import prefetcher as _prefetcher

            placing = _prefetcher.default_depth() > 0
            with ctx:
                while True:
                    self.data_taken[i].wait()
                    if not self.started:
                        break
                    try:
                        batch = self.iters[i].next()
                        if placing:
                            batch = _prefetcher.place(batch, ctx=ctx)
                        self.next_batch[i] = batch
                    except StopIteration:
                        self.next_batch[i] = None
                    self.data_taken[i].clear()
                    self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join(timeout=1)

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, \
                    "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    # -- resumable pipeline state ----------------------------------------------

    def _quiesce(self):
        """Wait until every prefetch thread parks (data_ready set):
        the child iterators are then untouched until data_taken."""
        for e in self.data_ready:
            e.wait()

    def state_dict(self):
        """Checkpointable position, exact at the DELIVERY point.  Each
        prefetch thread may hold one fetched-but-undelivered batch in
        ``next_batch[i]``; its child cursor is rolled back one batch in
        the recorded state, so restore re-fetches that batch instead of
        skipping it (the held batch itself is never serialized)."""
        self._quiesce()
        children = []
        for i, it in enumerate(self.iters):
            st = it.state_dict()
            if self.next_batch[i] is not None:
                st = dict(st)
                st["cursor"] = int(st["cursor"]) - self.batch_size
            children.append(st)
        return {"version": 1, "iters": children}

    def load_state_dict(self, sd):
        """Restore: the in-flight prefetched batches are DISCARDED (they
        belong to the pre-restore position) and the threads re-fetch
        from each child's restored cursor."""
        if not isinstance(sd, dict) or sd.get("version") != 1:
            raise ValueError(
                f"PrefetchingIter.load_state_dict: unsupported state "
                f"{type(sd).__name__} (want version-1 dict)")
        children = sd.get("iters")
        if not isinstance(children, list) or \
                len(children) != self.n_iter:
            raise ValueError(
                f"PrefetchingIter.load_state_dict: state has "
                f"{len(children) if isinstance(children, list) else '?'} "
                f"child iters, this prefetcher drives {self.n_iter}")
        self._quiesce()
        for it, st in zip(self.iters, children):
            it.load_state_dict(st)
        for i in range(self.n_iter):
            self.next_batch[i] = None
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return self


def _init_data(data, allow_empty, default_name):
    """Normalize data into list of (name, numpy) (reference: io._init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError(
            f"Input must be NDArray, numpy.ndarray, a list of them or dict "
            f"with them as values, got {type(data)}")
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                data[k] = _np.asarray(v)
            except Exception:
                raise TypeError(f"Invalid type '{type(v)}' for {k}")
    return list(sorted(data.items()))


def _getdata_by_idx(data, idx):
    shuffled = []
    for k, v in data:
        if isinstance(v, NDArray):
            v = v.asnumpy()
        shuffled.append((k, v[idx]))
    return shuffled


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.NDArrayIter) with
    pad/discard/roll_over last-batch handling and shuffling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        self.cursor = -self.batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        # roll_over: keep the tail for the next epoch
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        # discard: drop ragged tail
        if data[0].shape[0] != self.batch_size and \
                self.last_batch_handle == "discard":
            raise StopIteration
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        out = []
        for _, x in data_source:
            if isinstance(x, NDArray):
                x = x.asnumpy()
            out.append(_array(x[start:end]))
        return out

    def _concat(self, first_data, second_data):
        assert len(first_data) == len(second_data)
        out = []
        for x, y in zip(first_data, second_data):
            out.append(_array(_np.concatenate(
                (x.asnumpy(), y.asnumpy()), axis=0)))
        return out

    def _batchify(self, data_source):
        assert self.cursor < self.num_data, "DataIter need reset."
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            assert self._cache_data is not None or \
                self._cache_label is not None, \
                "next epoch should have cached data"
            cache = self._cache_data if self._cache_data is not None \
                else self._cache_label
            second = self._getdata(data_source,
                                   end=self.cursor + self.batch_size)
            return self._concat(cache, second)
        if self.cursor + self.batch_size <= self.num_data:
            return self._getdata(data_source, self.cursor,
                                 self.cursor + self.batch_size)
        if self.last_batch_handle == "pad":
            first = self._getdata(data_source, self.cursor)
            pad = self.batch_size - self.num_data + self.cursor
            second = self._getdata(data_source, end=pad)
            return self._concat(first, second)
        return self._getdata(data_source, self.cursor)

    def getdata(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor + self.batch_size >= self.num_data:
            # cache the tail for roll-over into next epoch
            self._cache_data = self._batchify(self.data) \
                if self._cache_data is None else self._cache_data
            return self._cache_data
        data = self._batchify(self.data)
        self._cache_data = None
        return data

    def getlabel(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor + self.batch_size >= self.num_data:
            self._cache_label = self._batchify(self.label) \
                if self._cache_label is None else self._cache_label
            return self._cache_label
        label = self._batchify(self.label)
        self._cache_label = None
        return label

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            return -self.cursor
        return 0

    def _shuffle_data(self):
        _np.random.shuffle(self.idx)
        self.data = _getdata_by_idx(self.data, self.idx)
        self.label = _getdata_by_idx(self.label, self.idx)

    # -- resumable pipeline state ----------------------------------------------

    def state_dict(self):
        """Exact position: the epoch's permutation (``idx`` — the data
        is physically reordered by it, so it IS the epoch order) plus
        the cursor.  JSON-serializable; rides the checkpoint manifest
        via `AsyncCheckpointer.save(..., data_state=...)`."""
        return {"version": 1, "cursor": int(self.cursor),
                "idx": [int(i) for i in self.idx]}

    def load_state_dict(self, sd):
        """Adopt a recorded position with zero re-read and zero skipped
        samples.  The data is currently ordered by ``self.idx``; the
        recorded epoch order is ``sd['idx']`` — a RELATIVE permutation
        re-orders in place (``argsort(current)[wanted]``), so restore
        never needs the original un-shuffled arrays."""
        if not isinstance(sd, dict) or sd.get("version") != 1:
            raise ValueError(
                f"NDArrayIter.load_state_dict: unsupported state "
                f"{type(sd).__name__} (want version-1 dict)")
        want = _np.asarray(sd["idx"], dtype=_np.int64)
        if want.shape[0] != self.num_data or \
                not _np.array_equal(_np.sort(want),
                                    _np.arange(self.num_data)):
            raise ValueError(
                f"NDArrayIter.load_state_dict: state permutes "
                f"{want.shape[0]} samples, iterator holds "
                f"{self.num_data} (or idx is not a permutation)")
        rel = _np.argsort(self.idx)[want]
        self.data = _getdata_by_idx(self.data, rel)
        self.label = _getdata_by_idx(self.label, rel)
        self.idx = want
        self.cursor = int(sd["cursor"])
        self._cache_data = None
        self._cache_label = None
        return self


def _array(np_arr):
    return from_host(np_arr)


class CSVIter(DataIter):
    """CSV reader (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = resilience.io_retry(
            lambda: _np.loadtxt(data_csv, delimiter=",", dtype=dtype),
            description=f"read {data_csv}")
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = resilience.io_retry(
                lambda: _np.loadtxt(label_csv, delimiter=",",
                                    dtype=dtype),
                description=f"read {label_csv}")
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = _np.zeros((data.shape[0],), dtype=dtype)
        self._iter = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="roll_over" if round_batch else "pad")
        self.provide_data = self._iter.provide_data
        self.provide_label = self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class MNISTIter(DataIter):
    """MNIST idx-format reader (reference: src/io/iter_mnist.cc)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_images(image)
        labels = self._read_labels(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, 28, 28)
        if input_shape is not None:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        imgs = imgs.astype(_np.float32) / 255.0
        self._iter = NDArrayIter(imgs, labels.astype(_np.float32),
                                 batch_size, shuffle=shuffle,
                                 last_batch_handle="discard")
        self.provide_data = self._iter.provide_data
        self.provide_label = self._iter.provide_label

    @staticmethod
    def _open(path):
        def opener():
            if path.endswith(".gz") or (not os.path.exists(path)
                                        and os.path.exists(path + ".gz")):
                return gzip.open(
                    path if path.endswith(".gz") else path + ".gz", "rb")
            return open(path, "rb")

        return resilience.io_retry(opener, description=f"open {path}")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            assert magic == 2051, f"bad MNIST image magic {magic}"
            return _np.frombuffer(f.read(n * rows * cols),
                                  dtype=_np.uint8).reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            assert magic == 2049, f"bad MNIST label magic {magic}"
            return _np.frombuffer(f.read(n), dtype=_np.uint8)

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class ImageRecordIter(DataIter):
    """RecordIO image reader + augmentation (reference:
    src/io/iter_image_recordio_2.cc).

    Decodes JPEG/PNG payloads from a .rec file, applies the reference's
    default augmenters (resize/crop/mirror — image.py), batches, and
    prefetches on a background thread.
    """

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 path_imgidx=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 resize=-1, round_batch=True, preprocess_threads=4,
                 prefetch_buffer=4, dtype="float32", skip_corrupt=False,
                 **kwargs):
        super().__init__(batch_size)
        from .. import recordio as rio
        from .. import image as img_mod

        self._rec = rio.MXRecordIO(path_imgrec, "r",
                                   skip_corrupt=skip_corrupt) \
            if path_imgidx is None \
            else rio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r",
                                       skip_corrupt=skip_corrupt)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.round_batch = round_batch
        self.mean = _np.array([mean_r, mean_g, mean_b],
                              dtype=_np.float32).reshape(3, 1, 1)
        self.std = _np.array([std_r, std_g, std_b],
                             dtype=_np.float32).reshape(3, 1, 1)
        self.scale = scale
        self.resize = resize
        self.preprocess_threads = preprocess_threads
        self._img = img_mod
        # index pass: record OFFSETS only (payloads stream per batch — the
        # reference's parser also reads chunks on demand, iter_image_
        # recordio_2.cc).  Native C++ codec (src/recordio.cc) is the fast
        # path; the python codec is the fallback.
        self._native = None
        try:
            from .. import _native

            if _native.available():
                self._native = _native.NativeRecordReader(path_imgrec)
                self._offsets = self._native.scan()
        except OSError:
            self._native = None
        if self._native is None:
            self._offsets = []
            while True:
                pos = self._rec.tell()
                rec = self._rec.read()
                if rec is None:
                    break
                self._offsets.append(pos)
        self._order = _np.arange(len(self._offsets))
        self.cursor = 0
        self.reset()

    def _read_at(self, offset):
        if self._native is not None:
            return self._native.read_at(offset)
        self._rec.seek(offset)
        return self._rec.read()

    @property
    def provide_data(self):
        return [DataDesc("data",
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self._order)
        self.cursor = 0

    def _next_indices(self):
        n = len(self._offsets)
        if n == 0 or self.cursor >= n:
            raise StopIteration
        avail = n - self.cursor
        if avail >= self.batch_size:
            idx = list(self._order[self.cursor:self.cursor
                                   + self.batch_size])
            self.cursor += self.batch_size
            return idx
        if not self.round_batch:
            raise StopIteration  # drop ragged tail
        # round-robin: complete the last batch from the epoch's start
        idx = list(self._order[self.cursor:]) \
            + list(self._order[:self.batch_size - avail])
        self.cursor = n
        return idx

    def _decode_crop_one(self, payload):
        """Python/PIL fallback: decode + resize + crop one image -> HWC
        uint8 (mirror/normalize happen batch-vectorized afterwards)."""
        _, h, w = self.data_shape
        arr = self._img.imdecode_np(payload)  # HWC uint8
        if self.resize > 0:
            arr = self._img.resize_short_np(arr, self.resize)
        if self.rand_crop:
            return self._img.random_crop_np(arr, (w, h))
        return self._img.center_crop_np(arr, (w, h))

    def _decode_one(self, payload, mirror_flag):
        """Fully-processed single image -> normalized CHW (used for the
        sparse non-JPEG stragglers inside a native-decoded batch)."""
        arr = self._decode_crop_one(payload)
        if mirror_flag:
            arr = arr[:, ::-1, :]
        chw = arr.astype(_np.float32).transpose(2, 0, 1)
        return (chw * self.scale - self.mean) / self.std

    def next(self):
        from .. import _native
        from .. import recordio as rio

        idx = self._next_indices()
        c, h, w = self.data_shape
        data = _np.empty((self.batch_size, c, h, w), dtype=_np.float32)
        label = _np.empty((self.batch_size, self.label_width),
                          dtype=_np.float32)
        payloads = []
        for i in range(self.batch_size):
            rec = self._read_at(self._offsets[idx[i]])
            header, payload = rio.unpack(rec)
            payloads.append(payload)
            lab = header.label
            label[i] = lab if _np.ndim(lab) else [lab] * self.label_width
        # randomness drawn HERE (one RNG, seed semantics stay in python);
        # the native kernel is pure given crop seeds + mirror flags
        mirror = (_np.random.rand(self.batch_size) < 0.5) \
            if self.rand_mirror else _np.zeros(self.batch_size, bool)
        if _native.has_jpeg() and c == 3:
            # native fast path: threaded libjpeg decode + fused augment
            # (reference: iter_image_recordio_2.cc + image_aug_default.cc)
            crop_modes = _np.full(self.batch_size,
                                  -2 if self.rand_crop else -1, _np.int32)
            # draw seeds only when used: center-crop eval runs must not
            # perturb the global RNG stream vs the python fallback
            seeds = _np.random.randint(
                0, 2 ** 62, self.batch_size).astype(_np.uint64) \
                if self.rand_crop else _np.zeros(self.batch_size,
                                                 _np.uint64)
            status = _native.decode_augment_batch(
                payloads, data, resize_short=self.resize,
                crop_modes=crop_modes, seeds=seeds,
                mirror=mirror.astype(_np.uint8), scale=self.scale,
                mean=self.mean.reshape(3), std=self.std.reshape(3),
                n_threads=self.preprocess_threads)
            for i in _np.nonzero(status == 0)[0]:
                # non-JPEG payloads (e.g. PNG): python codec fallback
                data[i] = self._decode_one(payloads[i], mirror[i])
        else:
            # pure-python batch: per-sample decode/crop into one uint8
            # NHWC staging buffer, then ONE vectorized flip+normalize
            # pass straight into the float32 output (bit-identical to the
            # old per-sample float path — see normalize_flip_batch_np)
            u8 = None
            for i in range(self.batch_size):
                arr = self._decode_crop_one(payloads[i])
                if u8 is None:
                    u8 = _np.empty((self.batch_size,) + arr.shape,
                                   arr.dtype)
                u8[i] = arr
            self._img.normalize_flip_batch_np(
                u8, mirror, self.scale, self.mean, self.std, out=data)
        # cursor was already advanced by _next_indices — advancing here
        # too skipped every other batch of the epoch
        return DataBatch(
            data=[_array(data)],
            label=[_array(label[:, 0] if self.label_width == 1 else label)],
            pad=0, index=None)


class LibSVMIter(DataIter):
    """LibSVM sparse text format reader (reference: src/io/iter_libsvm.cc).

    Batches carry CSR data (``stype="csr"``, the default, as the
    reference's do), so a linear model runs the compact ``sparse.dot``
    kernels with no dense (batch, dim) view; ``stype="default"`` gives
    dense batches."""

    def __init__(self, data_libsvm, data_shape, label_shape=None,
                 batch_size=1, round_batch=True, stype="csr", **kwargs):
        if stype not in ("csr", "default"):
            raise MXNetError(f"LibSVMIter: stype {stype!r} is not 'csr' "
                             "or 'default'")
        self._stype = stype
        super().__init__(batch_size)
        dim = data_shape[0] if isinstance(data_shape, (tuple, list)) \
            else data_shape
        self._dim = dim
        vals, cols, indptr, labels = [], [], [0], []
        with resilience.io_retry(lambda: open(data_libsvm),
                                 description=f"open {data_libsvm}") as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    cols.append(int(k))
                    vals.append(float(v))
                indptr.append(len(vals))
        self._vals = _np.asarray(vals, _np.float32)
        self._cols = _np.asarray(cols, _np.int32)
        self._indptr = _np.asarray(indptr, _np.int64)
        self._counts = _np.diff(self._indptr)
        self._labels = _np.asarray(labels, _np.float32)
        self._n = len(labels)
        self._round = round_batch
        self._cursor = 0
        self.provide_data = [DataDesc("data", (batch_size, dim))]
        lshape = label_shape or (1,)
        if not isinstance(lshape, (tuple, list)):
            lshape = (lshape,)
        if any(s > 1 for s in lshape):
            # the parser reads exactly one label per row; advertising a
            # wider shape would lie to bind-time shape inference
            raise MXNetError(
                f"LibSVMIter: label_shape {tuple(lshape)} unsupported — "
                "label_libsvm multi-label input is not implemented; one "
                "label per row only")
        self.provide_label = [DataDesc("softmax_label", (batch_size,))]

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= self._n:
            raise StopIteration
        lo = self._cursor
        hi = lo + self.batch_size
        pad = 0
        if hi > self._n and not self._round:
            pad = hi - self._n
        self._cursor = hi
        idx = _np.arange(lo, hi) % self._n
        label = _array(self._labels[idx])
        if self._stype == "csr":
            return DataBatch([self._rows_csr(idx)], [label], pad=pad)
        dense = _np.zeros((len(idx), self._dim), _np.float32)
        for r, i in enumerate(idx):
            s, e = self._indptr[i], self._indptr[i + 1]
            dense[r, self._cols[s:e]] = self._vals[s:e]
        data = _array(dense)
        return DataBatch([data], [label], pad=pad)

    def _rows_csr(self, idx):
        """The CSR slice of rows ``idx`` as a CSRNDArray on the current
        context."""
        from ..ndarray.sparse import csr_matrix

        counts = self._counts[idx]
        starts = self._indptr[idx]
        take = _np.concatenate(
            [_np.arange(s, s + c) for s, c in zip(starts, counts)]) \
            if len(idx) else _np.zeros((0,), _np.int64)
        indptr = _np.concatenate([[0], _np.cumsum(counts)])
        return csr_matrix((self._vals[take], self._cols[take], indptr),
                          shape=(len(idx), self._dim))
