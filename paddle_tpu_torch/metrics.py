"""Host-side streaming metrics (port of ``paddle_tpu/metrics.py``, a
numpy module copied as it is).

Parity with python/paddle/fluid/metrics.py: MetricBase, CompositeMetric,
Precision, Recall, Accuracy, ChunkEvaluator, EditDistance, DetectionMAP,
Auc — accumulated in python across minibatches, fed with fetched numpy
values.
"""
import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "ChunkEvaluator", "EditDistance", "DetectionMAP",
           "Auc"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, type(v)(0))
            elif isinstance(v, (list,)):
                setattr(self, k, [])

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def update(self, *args, **kwargs):
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

    def reset(self):
        for m in self._metrics:
            m.reset()

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision on thresholded predictions (reference
    fluid.metrics.Precision)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0


class Accuracy(MetricBase):
    """Weighted streaming accuracy: update(value, weight) with the
    per-batch accuracy fetched from layers.accuracy."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """F1 over chunk counts (reference fluid.metrics.ChunkEvaluator):
    update(num_infer_chunks, num_label_chunks, num_correct_chunks)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        def _int(v):
            return int(np.asarray(v).reshape(-1)[0])
        self.num_infer_chunks += _int(num_infer_chunks)
        self.num_label_chunks += _int(num_label_chunks)
        self.num_correct_chunks += _int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += int(np.asarray(seq_num).reshape(-1)[0])
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no batches accumulated")
        avg_distance = self.total_distance / self.seq_num
        instance_error_rate = self.instance_error / self.seq_num
        return avg_distance, instance_error_rate


class Auc(MetricBase):
    """Histogram-based streaming ROC AUC (reference fluid.metrics.Auc)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.stat_pos = np.zeros(num_thresholds + 1)
        self.stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self.stat_pos = np.zeros(self._num_thresholds + 1)
        self.stat_neg = np.zeros(self._num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        idx = np.clip((pos_prob * self._num_thresholds).astype(int), 0,
                      self._num_thresholds)
        bins = self._num_thresholds + 1
        self.stat_pos += np.bincount(idx[labels != 0], minlength=bins)
        self.stat_neg += np.bincount(idx[labels == 0], minlength=bins)

    def eval(self):
        tp = np.cumsum(self.stat_pos[::-1])
        fp = np.cumsum(self.stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        tpr0 = np.concatenate([[0.0], tpr[:-1]])
        fpr0 = np.concatenate([[0.0], fpr[:-1]])
        return float(np.sum((fpr - fpr0) * (tpr + tpr0) / 2.0))


class DetectionMAP(MetricBase):
    """Mean average precision for detection (11-point interpolated).
    update(pred_boxes_scores_labels, gt_labels) with decoded host data."""

    def __init__(self, name=None, overlap_threshold=0.5):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self._records = []

    def reset(self):
        self._records = []

    def update(self, scores, matched):
        self._records.extend(zip(np.asarray(scores).reshape(-1),
                                 np.asarray(matched).reshape(-1)))

    def eval(self):
        if not self._records:
            return 0.0
        rec = sorted(self._records, key=lambda r: -r[0])
        matched = np.asarray([m for _, m in rec])
        tp = np.cumsum(matched)
        fp = np.cumsum(1 - matched)
        npos = matched.sum() or 1
        recall = tp / npos
        precision = tp / np.maximum(tp + fp, 1)
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11
        return float(ap)
