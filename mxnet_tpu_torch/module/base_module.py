"""BaseModule: the classic train, score and predict loops.

Counterpart of ``mxnet_tpu/module/base_module.py:16-213`` (reference:
python/mxnet/module/base_module.py): ``fit``, ``score``, ``predict``,
``forward_backward``, ``prepare`` and ``install_monitor`` over a
subclass's bound executor, with ``BatchEndParam`` callbacks.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from ..model import BatchEndParam


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- the surface a subclass implements ------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, *args, **kwargs):
        raise NotImplementedError()

    def init_params(self, *args, **kwargs):
        raise NotImplementedError()

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Before a forward, pull the row-sparse parameter rows the batch
        touches (reference: BaseModule.prepare).  A Module binds dense
        parameters, so there is nothing to pull; ``sparse_row_id_fn`` is
        still called on the batch."""
        if sparse_row_id_fn is not None:
            sparse_row_id_fn(data_batch)

    def install_monitor(self, mon):
        """Attach a ``monitor.Monitor`` to this module's executor."""
        exe = getattr(self, "_exec", None)
        if exe is None:
            raise RuntimeError("install_monitor requires a bound module")
        mon.install(exe)

    # -- loops ----------------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate ``eval_metric`` over ``eval_data``; its name-value
        pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.prepare(eval_batch, sparse_row_id_fn=sparse_row_id_fn)
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        if score_end_callback:
            param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data``, the padding of a last partial
        batch dropped: merged along the batch axis into NDArrays on the
        module's context (one, unless ``always_output_list`` or the graph
        has several outputs), or a list of per-batch lists."""
        from .. import ndarray as nd

        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.prepare(eval_batch, sparse_row_id_fn=sparse_row_id_fn)
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outs = [o.asnumpy() for o in self.get_outputs()]
            output_list.append([o[:o.shape[0] - pad] for o in outs])
        if not output_list:
            return []
        if merge_batches:
            ctx = getattr(self, "_context", None)
            merged = [nd.array(np.concatenate([out[i]
                                               for out in output_list]),
                               ctx=ctx)
                      for i in range(len(output_list[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The classic training loop (reference: BaseModule.fit): bind,
        initialise, then for each epoch ``forward_backward``, the
        monitor's ``toc`` (before ``update`` changes the weights),
        ``update`` and the metric, batch by batch."""
        from .. import initializer as init_mod

        assert num_epoch is not None, "please specify number of epochs"
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if monitor is not None:
            self.install_monitor(monitor)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.prepare(data_batch, sparse_row_id_fn=sparse_row_id_fn)
                self.forward_backward(data_batch)
                if monitor is not None:
                    monitor.toc_print()
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    @property
    def symbol(self):
        return self._symbol
