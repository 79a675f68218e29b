"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``; reference:
python/mxnet/gluon/data/)."""

from .dataset import (ArrayDataset, Dataset, RecordFileDataset,
                      SimpleDataset)
from .sampler import (BatchSampler, FilterSampler, RandomSampler,
                      ResumableSampler, Sampler, SequentialSampler)
from .dataloader import (DataLoader, DataLoaderWorkerError,
                         default_batchify_fn, default_mp_batchify_fn)
from .prefetcher import DevicePrefetcher
from .state import DataPipelineState, epoch_order
from . import vision
