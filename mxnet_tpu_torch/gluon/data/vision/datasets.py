"""Vision datasets.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py`` (reference:
python/mxnet/gluon/data/vision/datasets.py): MNIST, FashionMNIST,
CIFAR10, CIFAR100, ImageRecordDataset, ImageFolderDataset.

They read local files only: a dataset reads from ``root`` if the
standard files are there and raises a clear error otherwise (the
reference would download; nothing here does).  Images are NDArrays on
the context current where the dataset is built.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as _np

from ....base import MXNetError
from ...block import Block  # noqa: F401  (parity import)
from ..dataset import ArrayDataset, Dataset, RecordFileDataset
from ....ndarray.ndarray import from_host


def _to_nd(arr):
    return from_host(arr)


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (reference: gluon.data.vision.MNIST); expects the idx files
    under root."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _open(self, name):
        path = os.path.join(self._root, name)
        if os.path.exists(path):
            return open(path, "rb")
        if os.path.exists(path + ".gz"):
            return gzip.open(path + ".gz", "rb")
        raise MXNetError(
            f"MNIST file {name} not found under {self._root} and this "
            "package downloads nothing. Place the idx files there.")

    def _get_data(self):
        image_file, label_file = self._train_files if self._train \
            else self._test_files
        with self._open(label_file) as fin:
            struct.unpack(">II", fin.read(8))
            label = _np.frombuffer(fin.read(), dtype=_np.uint8) \
                .astype(_np.int32)
        with self._open(image_file) as fin:
            struct.unpack(">IIII", fin.read(16))
            data = _np.frombuffer(fin.read(), dtype=_np.uint8)
            data = data.reshape(len(label), 28, 28, 1)
        self._data = _to_nd(data)
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 (reference: gluon.data.vision.CIFAR10); expects the python
    pickle batches or the binary batches under root."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._archive_file_name = "cifar-10-binary.tar.gz"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(_np.int32)

    def _get_data(self):
        if self._train:
            filename = [os.path.join(self._root,
                                     f"data_batch_{i + 1}.bin")
                        for i in range(5)]
        else:
            filename = [os.path.join(self._root, "test_batch.bin")]
        missing = [f for f in filename if not os.path.exists(f)]
        if missing:
            archive = os.path.join(self._root, self._archive_file_name)
            if os.path.exists(archive):
                with tarfile.open(archive) as tar:
                    tar.extractall(self._root)
                # binary batches live in a subdir
                sub = os.path.join(self._root, "cifar-10-batches-bin")
                if os.path.isdir(sub):
                    for f in os.listdir(sub):
                        os.replace(os.path.join(sub, f),
                                   os.path.join(self._root, f))
            missing = [f for f in filename if not os.path.exists(f)]
        if missing:
            raise MXNetError(
                f"CIFAR10 files {missing} not found under {self._root}; "
                "this package downloads nothing.")
        data, label = zip(*[self._read_batch(f) for f in filename])
        self._data = _to_nd(_np.concatenate(data))
        self._label = _np.concatenate(label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._train = train
        self._archive_file_name = "cifar-100-binary.tar.gz"
        _DownloadedDataset.__init__(self, root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(
                -1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(_np.int32)

    def _get_data(self):
        filename = [os.path.join(self._root,
                                 "train.bin" if self._train else "test.bin")]
        missing = [f for f in filename if not os.path.exists(f)]
        if missing:
            raise MXNetError(
                f"CIFAR100 files {missing} not found under {self._root}; "
                "this package downloads nothing.")
        data, label = zip(*[self._read_batch(f) for f in filename])
        self._data = _to_nd(_np.concatenate(data))
        self._label = _np.concatenate(label)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a .rec file (reference:
    gluon.data.vision.ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image, recordio

        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        arr = image.imdecode(img, flag=self._flag)
        if self._transform is not None:
            return self._transform(arr, header.label)
        return arr, header.label


class ImageFolderDataset(Dataset):
    """root/class/image.jpg layout (reference:
    gluon.data.vision.ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from .... import image

        img = image.imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
