"""Data iterators (counterpart of ``mxnet_tpu/io/``; reference:
python/mxnet/io/ + src/io/)."""

from .io import (DataDesc, DataBatch, DataIter, ResizeIter, PrefetchingIter,
                 NDArrayIter, CSVIter, MNISTIter, ImageRecordIter,
                 LibSVMIter)
