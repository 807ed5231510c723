"""Python metric accumulators over fetched numpy values (counterpart of
paddle_tpu/metrics.py, the reference's python/paddle/fluid/metrics.py):
MetricBase, CompositeMetric, Precision, Recall, Accuracy, EditDistance
and Auc. numpy only."""
from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "EditDistance", "Auc"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k in list(self.__dict__):
            if not k.startswith("_"):
                setattr(self, k, 0.0)

    def update(self, *a, **kw):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return float(self.tp) / d if d else 0.0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / self.weight if self.weight else 0.0


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        avg = self.total_distance / self.seq_num if self.seq_num else 0.0
        err = self.instance_error / self.seq_num if self.seq_num else 0.0
        return avg, err


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((pos_prob * self._num_thresholds).astype(int), 0,
                         self._num_thresholds)
        np.add.at(self._stat_pos, bucket, labels == 1)
        np.add.at(self._stat_neg, bucket, labels == 0)

    def eval(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos * tot_neg == 0:
            return 0.0
        pos_c = np.cumsum(self._stat_pos[::-1])
        neg_c = np.cumsum(self._stat_neg[::-1])
        pos_prev = np.concatenate([[0], pos_c[:-1]])
        neg_prev = np.concatenate([[0], neg_c[:-1]])
        area = np.sum((neg_c - neg_prev) * (pos_c + pos_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))
