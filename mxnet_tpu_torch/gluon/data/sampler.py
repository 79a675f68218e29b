"""Samplers.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py`` (reference:
python/mxnet/gluon/data/sampler.py): Sequential, Random, Filter and Batch
samplers with the reference's ``last_batch`` modes, and the seeded,
shardable ``ResumableSampler`` over a ``state.DataPipelineState``.
Host code only.
"""

from __future__ import annotations

import numpy as _np


class Sampler:
    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = _np.arange(self._length)
        _np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class ResumableSampler(Sampler):
    """Seeded, shardable, checkpoint-resumable sample order.

    No reference analog: draws from a shared
    :class:`~mxnet_tpu_torch.gluon.data.state.DataPipelineState` — each
    ``__iter__`` yields THIS rank's slice of the epoch's *remaining*
    sample space (``order[cursor:][rank::world]``; see state.py for the
    exactness model).  The epoch order is a pure function of
    ``(seed, epoch)``, never the global RNG, so a restored or reshaped
    gang reconstructs the identical order.  The cursor itself is
    advanced by the delivering iterator (DataLoader), not here:
    sampling runs ahead of delivery under prefetch, and the checkpoint
    must record what was delivered.
    """

    def __init__(self, state):
        self._state = state

    @property
    def state(self):
        return self._state

    def __iter__(self):
        return iter(self._state.shard().tolist())

    def __len__(self):
        return self._state.shard_len()


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._fn = fn
        self._dataset = dataset
        self._indices = [i for i, sample in enumerate(dataset)
                         if fn(sample)]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """Wraps a Sampler into batches with last_batch handling (reference:
    gluon.data.BatchSampler)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    f"'rollover', but got {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) \
                // self._batch_size
        raise ValueError(
            "last_batch must be one of 'keep', 'discard', or 'rollover', "
            f"but got {self._last_batch}")
