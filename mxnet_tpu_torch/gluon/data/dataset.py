"""Datasets.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py`` (reference:
python/mxnet/gluon/data/dataset.py): Dataset, SimpleDataset,
ArrayDataset, RecordFileDataset, and the lazy ``transform`` /
``transform_first`` views.
"""

from __future__ import annotations

import os
import threading

from ...ndarray.ndarray import NDArray


class Dataset:
    """Abstract dataset (reference: gluon.data.Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        if count is None or count > len(self):
            count = len(self)
        return SimpleDataset([self[i] for i in range(count)])

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([i for i in trans])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (reference: gluon.data.ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; array[0] has " \
                f"length {self._length} while array[{i}] has {len(data)}."
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Raw records from a .rec file (reference:
    gluon.data.RecordFileDataset).  A read is a seek and a read on one
    shared file handle, so reads hold a lock: a DataLoader's worker
    threads may fetch concurrently (a spawned worker unpickles its own
    handle and lock)."""

    def __init__(self, filename):
        from ... import recordio

        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock")
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
