"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference: python/mxnet/metric.py):
the EvalMetric registry (Accuracy, TopKAccuracy, F1, MCC, Perplexity,
CrossEntropy, NLL, MAE, MSE, RMSE, PearsonCorrelation, Loss, Caffe,
CompositeEvalMetric, CustomMetric and ``mx.metric.np``), ``create`` and
``check_label_shapes``; the port keeps its own copy of the numpy parts.

Metric math runs on host numpy, except the hot classification metrics
(Accuracy, TopKAccuracy): when label and prediction are both NDArrays,
argmax/argsort, compare and count run as a torch reduction on their device
and only the count is read back, so a batch's logits never cross to the
host.
"""

from __future__ import annotations

import math

import numpy

from .ndarray.ndarray import NDArray

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*aliases):
    def reg(klass):
        for a in aliases:
            _METRIC_REGISTRY[a.lower()] = klass
        return klass
    return reg


def create(metric, *args, **kwargs):
    """mx.metric.create — from name, callable, or list."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, str):
        if metric.lower() not in _METRIC_REGISTRY:
            raise ValueError(f"Cannot find metric {metric}")
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise TypeError("metric should be a str, callable, list or EvalMetric")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval(label, pred) into a metric (reference:
    mx.metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name if name is not None else numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def _to_numpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


def _device_correct_count(kind, pred, label, **static):
    """Correct-prediction count as a torch reduction on the tensors'
    device: the returned 0-dim tensor is the caller's one host readback,
    so the logits never cross to the host."""
    import torch

    if kind == "acc":
        p = torch.argmax(pred, dim=static["axis"]) \
            if static["need_argmax"] else pred
        return (p.to(torch.int32).reshape(-1)
                == label.to(torch.int32).reshape(-1)).sum()
    # top-k: a stable ascending argsort, as numpy's on the host path
    order = torch.argsort(pred.to(torch.float32), dim=-1, stable=True)
    lab = label.to(torch.int32).reshape(-1)
    if order.dim() == 1:
        return (order == lab).sum()
    num_classes = order.shape[1]
    hits = torch.zeros((), dtype=torch.int64, device=order.device)
    for j in range(min(num_classes, static["top_k"])):
        hits = hits + (order[:, num_classes - 1 - j] == lab).sum()
    return hits


class EvalMetric:
    """Base class (reference: mx.metric.EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._has_global_stats = kwargs.pop("has_global_stats", False)
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self._has_global_stats:
            if self.global_num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.global_sum_metric / self.global_num_inst)
        return self.get()

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        if self._has_global_stats:
            name, value = self.get_global()
            if not isinstance(name, list):
                name = [name]
            if not isinstance(value, list):
                value = [value]
            return list(zip(name, value))
        return self.get_name_value()

    def _update(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst


@register
@alias("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        counts = []  # (device scalar, n) pairs; one readback after the loop
        for label, pred_label in zip(labels, preds):
            if isinstance(pred_label, NDArray) and isinstance(label, NDArray):
                pshape = tuple(pred_label.shape)
                lshape = tuple(label.shape)
                need_argmax = pshape != lshape
                if need_argmax:
                    ax = self.axis % len(pshape)
                    out_size = math.prod(
                        s for d, s in enumerate(pshape) if d != ax)
                else:
                    out_size = math.prod(pshape)
                check_label_shapes(range(math.prod(lshape)), range(out_size))
                dev = _device_correct_count(
                    "acc", pred_label._data, label._data,
                    axis=self.axis, need_argmax=need_argmax)
                counts.append((dev, out_size))
                continue
            pred = _to_numpy(pred_label)
            label_np = _to_numpy(label).astype("int32")
            if pred.shape != label_np.shape:
                pred = numpy.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flatten()
            label_np = label_np.flatten()
            check_label_shapes(label_np, pred)
            correct = (pred == label_np).sum()
            self._update(float(correct), len(pred))
        if counts:
            total = counts[0][0] if len(counts) == 1 \
                else sum(c for c, _ in counts)
            self._update(float(total.item()), sum(n for _, n in counts))


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        counts = []  # (device scalar, n) pairs; one readback after the loop
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, \
                "Predictions should be no more than 2 dims"
            if isinstance(pred_label, NDArray) and isinstance(label, NDArray):
                check_label_shapes(range(label.shape[0]),
                                   range(pred_label.shape[0]))
                dev = _device_correct_count(
                    "topk", pred_label._data, label._data, top_k=self.top_k)
                counts.append((dev, pred_label.shape[0]))
                continue
            pred = numpy.argsort(_to_numpy(pred_label).astype("float32"),
                                 axis=-1)
            label_np = _to_numpy(label).astype("int32")
            check_label_shapes(label_np, pred)
            num_samples = pred.shape[0]
            num_dims = len(pred.shape)
            if num_dims == 1:
                self._update(float((pred.flatten() == label_np.flatten())
                                   .sum()), num_samples)
            elif num_dims == 2:
                num_classes = pred.shape[1]
                top_k = min(num_classes, self.top_k)
                correct = 0.0
                for j in range(top_k):
                    correct += float((pred[:, num_classes - 1 - j].flatten()
                                      == label_np.flatten()).sum())
                self._update(correct, num_samples)
        if counts:
            total = counts[0][0] if len(counts) == 1 \
                else sum(c for c, _ in counts)
            self._update(float(total.item()), sum(n for _, n in counts))


class _BinaryClassificationMetrics:
    """Running TP/FP/TN/FN counters (reference: metric.py helper)."""

    def __init__(self):
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        pred_np = _to_numpy(pred)
        label_np = _to_numpy(label).astype("int32")
        pred_label = numpy.argmax(pred_np, axis=1) if pred_np.ndim > 1 \
            else (pred_np > 0.5).astype("int32")
        check_label_shapes(label_np.flatten(), pred_label.flatten())
        if len(numpy.unique(label_np)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % type(self).__name__)
        pred_label = pred_label.flatten()
        label_np = label_np.flatten()
        pred_true = (pred_label == 1)
        pred_false = ~pred_true
        label_true = (label_np == 1)
        label_false = ~label_true
        self.true_positives += (pred_true & label_true).sum()
        self.false_positives += (pred_true & label_false).sum()
        self.false_negatives += (pred_false & label_true).sum()
        self.true_negatives += (pred_false & label_false).sum()

    @property
    def precision(self):
        tp_fp = self.true_positives + self.false_positives
        return self.true_positives / tp_fp if tp_fp > 0 else 0.0

    @property
    def recall(self):
        tp_fn = self.true_positives + self.false_negatives
        return self.true_positives / tp_fn if tp_fn > 0 else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return (2 * self.precision * self.recall
                    / (self.precision + self.recall))
        return 0.0

    @property
    def matthewscc(self):
        if not self.total_examples:
            return 0.0
        true_pos = float(self.true_positives)
        false_pos = float(self.false_positives)
        false_neg = float(self.false_negatives)
        true_neg = float(self.true_negatives)
        terms = [(true_pos + false_pos), (true_pos + false_neg),
                 (true_neg + false_pos), (true_neg + false_neg)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((true_pos * true_neg - false_pos * false_neg)
                / math.sqrt(denom))

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives
                + self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.global_sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.global_num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore \
                * self.metrics.total_examples
            self.global_sum_metric = self.sum_metric
            self.num_inst = self.metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self._metrics.matthewscc
            self.global_sum_metric += self._metrics.matthewscc
            self.num_inst += 1
            self.global_num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = (self._metrics.matthewscc
                               * self._metrics.total_examples)
            self.global_sum_metric = self.sum_metric
            self.num_inst = self._metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0.0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label).astype("int32").flatten()
            pred_np = _to_numpy(pred)
            pred_np = pred_np.reshape(-1, pred_np.shape[-1])
            assert label_np.shape[0] == pred_np.shape[0], \
                "shape mismatch between label and prediction"
            probs = pred_np[numpy.arange(label_np.shape[0]), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label)
                probs = numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label_np.shape[0]
        self._update(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        if self._has_global_stats:
            if self.global_num_inst == 0:
                return (self.name, float("nan"))
            return (self.name,
                    math.exp(self.global_sum_metric / self.global_num_inst))
        return self.get()


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            label_np = label_np.ravel()
            assert label_np.shape[0] == pred_np.shape[0]
            prob = pred_np[numpy.arange(label_np.shape[0]),
                           numpy.int64(label_np)]
            cross_entropy = (-numpy.log(prob + self.eps)).sum()
            self._update(cross_entropy, label_np.shape[0])


@register
@alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            label_np = label_np.ravel()
            num_examples = pred_np.shape[0]
            assert label_np.shape[0] == num_examples
            prob = pred_np[numpy.arange(num_examples),
                           numpy.int64(label_np)]
            nll = (-numpy.log(prob + self.eps)).sum()
            self._update(nll, num_examples)


@register
@alias("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            self._update(numpy.abs(label_np - pred_np).mean(), 1)


@register
@alias("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            self._update(((label_np - pred_np) ** 2.0).mean(), 1)


@register
@alias("rmse")
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            self._update(numpy.sqrt(((label_np - pred_np) ** 2.0).mean()), 1)


@register
@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _to_numpy(label).ravel()
            pred_np = _to_numpy(pred).ravel()
            check_label_shapes(label_np, pred_np, False, True)
            self._update(numpy.corrcoef(pred_np, label_np)[0, 1], 1)


@register
class Loss(EvalMetric):
    """Dummy metric for directly printing loss outputs (reference:
    mx.metric.Loss).

    Non-finite loss values are EXCLUDED from the running sum — a single
    NaN would otherwise poison the average for the rest of the epoch
    (``sum_metric`` can never recover from ``nan + x``).  The excluded
    count is tracked in ``num_nonfinite`` and warned about once per
    reset, so divergence stays visible without wrecking the report.
    """

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.num_nonfinite = 0

    def update(self, _, preds):
        if isinstance(preds, (list, tuple)) is False:
            preds = [preds]
        for pred in preds:
            arr = _to_numpy(pred)
            finite = numpy.isfinite(arr)
            if finite.all():
                self._update(float(arr.sum()), int(arr.size))
                continue
            n_bad = int(arr.size - finite.sum())
            if self.num_nonfinite == 0:
                import warnings

                warnings.warn(
                    f"Loss metric '{self.name}': {n_bad} non-finite "
                    "value(s) excluded from the running sum (see "
                    "num_nonfinite)", RuntimeWarning, stacklevel=2)
            self.num_nonfinite += n_bad
            self._update(float(arr[finite].sum()), int(finite.sum()))

    def reset(self):
        super().reset()
        self.num_nonfinite = 0


@register
class Caffe(Loss):
    pass


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 and "
                              f"{len(self.metrics)}")

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {name: label for name, label in labels.items()
                      if name in self.label_names}
        if self.output_names is not None:
            preds = {name: pred for name, pred in preds.items()
                     if name in self.output_names}
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def reset_local(self):
        try:
            for metric in self.metrics:
                metric.reset_local()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, complex)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_global(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get_global()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, complex)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label_np = _to_numpy(label)
            pred_np = _to_numpy(pred)
            reval = self._feval(label_np, pred_np)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self._update(sum_metric, num_inst)
            else:
                self._update(reval, 1)

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")
