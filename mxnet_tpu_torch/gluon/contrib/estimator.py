"""Estimator: Gluon's high-level fit loop.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator.py`` (reference:
python/mxnet/gluon/contrib/estimator): ``fit`` trains over a batch source
for some epochs with ``autograd.record()``, ``backward`` and
``trainer.step``, updating the training metrics after each batch;
``evaluate`` runs the net over a source and returns the metrics.
``fit`` reads its sources through a ``DevicePrefetcher`` (unless
``MXTPU_DEVICE_PREFETCH=0``), so the next batch's copy to the card
overlaps the current step.
"""

from __future__ import annotations

import time

from ... import autograd, metric as metric_mod
from ..data.prefetcher import DevicePrefetcher, default_depth


def _maybe_prefetch(data):
    """``data`` behind a ``DevicePrefetcher``, unless it is one already or
    prefetch is off."""
    if data is None or isinstance(data, DevicePrefetcher) \
            or default_depth() <= 0:
        return data
    return DevicePrefetcher(data)


class Estimator:
    """``net`` trained on ``loss`` by ``trainer``, scored by ``metrics``
    (names or metric objects, default accuracy)."""

    def __init__(self, net, loss, metrics=None, trainer=None):
        self.net = net
        self.loss = loss
        self.train_metrics = [metric_mod.create(m)
                              for m in (metrics or ["acc"])]
        self.trainer = trainer

    def evaluate(self, val_data, metrics=None):
        """The metrics' ``get()`` after one pass over ``val_data``."""
        metrics = [metric_mod.create(m) for m in metrics] \
            if metrics else self.train_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            x, y = self._split(batch)
            out = self.net(x)
            for m in metrics:
                m.update([y], [out])
        return [m.get() for m in metrics]

    @staticmethod
    def _split(batch):
        if isinstance(batch, (list, tuple)):
            return batch[0], batch[1]
        return batch.data[0], batch.label[0]

    def fit(self, train_data, val_data=None, epochs=1,
            batch_end_callback=None, epoch_end_callback=None):
        """Train ``epochs`` passes over ``train_data``; after each,
        ``evaluate(val_data)`` if given."""
        train_data = _maybe_prefetch(train_data)
        val_data = _maybe_prefetch(val_data)
        for epoch in range(epochs):
            tic = time.time()
            for m in self.train_metrics:
                m.reset()
            if hasattr(train_data, "reset"):
                train_data.reset()
            nbatch = 0
            for batch in train_data:
                x, y = self._split(batch)
                with autograd.record():
                    out = self.net(x)
                    loss = self.loss(out, y)
                loss.backward()
                self.trainer.step(x.shape[0])
                for m in self.train_metrics:
                    m.update([y], [out])
                nbatch += 1
                if batch_end_callback:
                    batch_end_callback(epoch, nbatch, self.train_metrics)
            if epoch_end_callback:
                epoch_end_callback(epoch, self.train_metrics,
                                   time.time() - tic)
            if val_data is not None:
                self.evaluate(val_data)
        return self
