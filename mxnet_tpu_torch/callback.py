"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (reference:
python/mxnet/callback.py): Speedometer (the samples/sec throughput
logger), ProgressBar, BatchEndParam, log_train_metric,
LogValidationMetricsCallback, and the checkpoint callbacks
``do_checkpoint`` / ``module_checkpoint``, which write the reference's
``prefix-%04d.params`` files (``arg:``/``aux:`` keys) with ``nd.save``.
"""

from __future__ import annotations

import logging
import math
import sys
import time


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving module checkpoints (reference:
    mx.callback.module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving symbol+params (reference:
    mx.callback.do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-%04d.params`` with ``nd.save``, the arguments under
    ``arg:name`` and the auxiliary states under ``aux:name``, and
    ``prefix-symbol.json`` when a symbol is given (reference:
    mx.model.save_checkpoint)."""
    from .ndarray import save as nd_save

    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{name}": v for name, v in arg_params.items()}
    save_dict.update({f"aux:{name}": v for name, v in aux_params.items()})
    nd_save(f"{prefix}-{epoch:04d}.params", save_dict)


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the eval metric every `period` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """Logs throughput (samples/sec) and metrics every `frequent` batches
    (reference: mx.callback.Speedometer).  The count is per process."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        self.last_speed = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                try:
                    speed = (self.frequent * self.batch_size
                             / (time.time() - self.tic))
                except ZeroDivisionError:
                    speed = float("inf")
                self.last_speed = speed
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset_local()
                    msg = "Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count - self.frequent,
                                 count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """ASCII progress bar batch-end callback (reference:
    mx.callback.ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")


class LogValidationMetricsCallback:
    """Epoch-end callback logging validation metrics."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)


class BatchEndParam:
    """Named bundle passed to batch/epoch callbacks (reference:
    mx.model.BatchEndParam namedtuple)."""

    __slots__ = ("epoch", "nbatch", "eval_metric", "locals")

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals
