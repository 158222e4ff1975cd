"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; ref:
python/mxnet/metric.py), copied: the reference module imports no JAX,
but the port imports nothing of it.

As in the reference, ``update()`` calls ``asnumpy()``, so a metric
update is a sync with the card: keep updates infrequent in hot loops.
``np_metric`` wraps a numpy function as upstream's ``mx.metric.np``
does (the reference leaves it unimplemented).
"""
from __future__ import annotations

import numpy as np

from .base import Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "NegativeLogLikelihood", "Perplexity",
           "Loss", "PearsonCorrelation", "CompositeEvalMetric", "CustomMetric",
           "create", "np_metric", "check_label_shapes"]

_REG = Registry("metric")
register = _REG.register


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError("labels and predictions differ in length")
    return labels, preds


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register("acc")
@register()
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy() if isinstance(pred, NDArray) else np.asarray(pred)
            label = label.asnumpy() if isinstance(label, NDArray) else np.asarray(label)
            if pred.ndim > label.ndim:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flat
            label = label.astype("int32").flat
            n = min(len(label), len(pred))
            self.sum_metric += float((np.asarray(pred[:n]) == np.asarray(label[:n])).sum())
            self.num_inst += n


@register("top_k_accuracy")
@register("top_k_acc")
@register()
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, top_k=top_k)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy() if isinstance(pred, NDArray) else np.asarray(pred)
            label = label.asnumpy() if isinstance(label, NDArray) else np.asarray(label)
            assert pred.ndim == 2
            topk = np.argsort(pred, axis=1)[:, -self.top_k:]
            n = label.shape[0]
            for j in range(self.top_k):
                self.sum_metric += float((topk[:, j] == label.astype("int32")).sum())
            self.num_inst += n


@register()
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy() if isinstance(pred, NDArray) else np.asarray(pred)
            label = label.asnumpy().astype("int32") if isinstance(label, NDArray) \
                else np.asarray(label).astype("int32")
            if pred.ndim > 1:
                pred = np.argmax(pred, axis=1)
            pred = pred.astype("int32")
            self._tp += float(np.sum((pred == 1) & (label == 1)))
            self._fp += float(np.sum((pred == 1) & (label == 0)))
            self._fn += float(np.sum((pred == 0) & (label == 1)))
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register()
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(np.abs(label - pred).mean())
            self.num_inst += 1


@register()
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register()
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(np.sqrt(self.sum_metric / self.num_inst)))


@register("ce")
@register("cross-entropy")
@register()
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[np.arange(label.shape[0]), np.int64(label)]
            self.sum_metric += float((-np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register("nll_loss")
@register()
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register()
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            flat_label = label.ravel().astype("int64")
            probs = pred.reshape(-1, pred.shape[-1])
            prob = probs[np.arange(flat_label.shape[0]), flat_label]
            if self.ignore_label is not None:
                ignore = (flat_label == self.ignore_label)
                prob = np.where(ignore, 1.0, prob)
                num -= int(ignore.sum())
            loss += float(-np.log(np.maximum(1e-10, prob)).sum())
            num += prob.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(np.exp(self.sum_metric / self.num_inst)))


@register()
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            loss = float(pred.asnumpy().sum())
            self.sum_metric += loss
            self.num_inst += pred.size


@register()
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = label.asnumpy().ravel()
            pred = pred.asnumpy().ravel()
            self.sum_metric += float(np.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
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

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, np.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
        super().__init__(name, output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label = label.asnumpy()
            pred = pred.asnumpy()
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _REG.create(metric, *args, **kwargs)


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` from ``numpy_feval(label, pred)`` on numpy
    arrays (ref: upstream metric.py :: np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
