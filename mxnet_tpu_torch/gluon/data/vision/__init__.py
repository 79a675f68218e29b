"""Vision data (counterpart of ``mxnet_tpu/gluon/data/vision/``;
reference: python/mxnet/gluon/data/vision/)."""

from .datasets import (CIFAR10, CIFAR100, FashionMNIST, ImageFolderDataset,
                       ImageRecordDataset, MNIST)
from . import transforms
