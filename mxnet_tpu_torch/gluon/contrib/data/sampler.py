"""Contrib samplers (counterpart of
``mxnet_tpu/gluon/contrib/data/sampler.py``; reference:
gluon/contrib/data/sampler.py)."""

from __future__ import annotations

from ...data.sampler import Sampler


class IntervalSampler(Sampler):
    """Samples i, i+interval, i+2*interval, ... for each start i —
    the strided-corpus sampler BPTT language-model training uses
    (reference: contrib.data.IntervalSampler)."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, (
            f"IntervalSampler: interval {interval} must not exceed "
            f"length {length}")
        self._length = int(length)
        self._interval = int(interval)
        self._rollover = bool(rollover)

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
