"""Legacy in-program Evaluator API (port of ``paddle_tpu/evaluator.py``;
reference python/paddle/fluid/evaluator.py — deprecated there in favor of
fluid.metrics, kept for API parity).

The reference versions allocate accumulator variables inside the program
and append update ops; here each evaluator keeps its totals host-side
(identical results, no graph mutation) and exposes the same
create/eval/reset surface.
"""
import warnings

import numpy as np

from . import metrics as _metrics
from .core.executor import global_scope

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator:
    def __init__(self, name, **kwargs):
        warnings.warn(
            f"fluid.evaluator.{name} is deprecated — use fluid.metrics."
            f"{name} (parity with the reference's deprecation)")
        self.metrics = []
        self.states = []

    def reset(self, executor, reset_program=None):
        self._m.reset()

    def eval(self, executor, eval_program=None):
        raise NotImplementedError


class ChunkEvaluator(Evaluator):
    """Accumulates chunk counts from layers.chunk_eval outputs
    (reference evaluator.py ChunkEvaluator)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("ChunkEvaluator")
        from .layers import metric_op
        (self.precision, self.recall, self.f1_score, self._num_infer,
         self._num_label, self._num_correct) = metric_op.chunk_eval(
            input, label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self.metrics = [self.precision, self.recall, self.f1_score]
        self._m = _metrics.ChunkEvaluator()

    def update(self, num_infer, num_label, num_correct):
        self._m.update(num_infer, num_label, num_correct)

    def eval(self, executor, eval_program=None):
        return self._m.eval()


class EditDistance(Evaluator):
    def __init__(self, input, label, ignored_tokens=None):
        super().__init__("EditDistance")
        from . import layers
        self.distances, self._seq_num = layers.edit_distance(
            input, label, ignored_tokens=ignored_tokens)
        self.metrics = [self.distances]
        self._m = _metrics.EditDistance()

    def update(self, distances, seq_num=None):
        d = np.asarray(distances)
        self._m.update(d, seq_num if seq_num is not None else d.shape[0])

    def eval(self, executor, eval_program=None):
        return self._m.eval()


class DetectionMAP(Evaluator):
    """Dataset-level VOC mAP (reference evaluator.py DetectionMAP).

    The reference accumulates AccumTruePos/AccumFalsePos/AccumPosCount
    in-program; here the detection_map op emits per-batch MatchInfo
    rows [label, score, tp, valid] + per-class GTCount, the evaluator
    accumulates them host-side, and eval() computes the dataset AP —
    the same metric, without in-graph dynamic state."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        super().__init__("DetectionMAP")
        from . import layers
        from .layers import detection
        # the op's 6-wide Label rows are [label, difficult, x1..y2]
        # (reference detection_map_op.h GetBoxes order)
        if gt_difficult is not None:
            parts = [layers.cast(gt_label, "float32"),
                     layers.cast(gt_difficult, "float32"), gt_box]
        else:
            parts = [layers.cast(gt_label, "float32"), gt_box]
        label = layers.concat(parts, axis=-1)
        self.cur_map = detection.detection_map(
            input, label, class_num=class_num,
            background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult,
            ap_version=ap_version)
        # fetch [cur_map, match_info, gt_count] and feed them to update()
        self.metrics = [self.cur_map, self.cur_map.match_info,
                        self.cur_map.gt_count]
        self._class_num = class_num
        self._background = background_label
        self._ap_version = ap_version
        self._values = []
        self._match_rows = []
        self._gt_counts = np.zeros((class_num,), np.int64)

    def update(self, value, match_info=None, gt_count=None):
        self._values.append(float(np.asarray(value).reshape(())))
        if match_info is not None:
            rows = np.asarray(match_info).reshape(-1, 4)
            self._match_rows.append(rows[rows[:, 3] > 0])
        if gt_count is not None:
            self._gt_counts += np.asarray(gt_count).reshape(-1)

    def reset(self, executor, reset_program=None):
        self._values = []
        self._match_rows = []
        self._gt_counts = np.zeros((self._class_num,), np.int64)

    def _dataset_map(self):
        rows = np.concatenate(self._match_rows, axis=0)
        aps = []
        for c in range(self._class_num):
            if c == self._background:
                continue
            n_gt = int(self._gt_counts[c])
            if n_gt == 0:
                continue
            sel = rows[rows[:, 0].astype(np.int64) == c]
            if sel.shape[0] == 0:
                aps.append(0.0)
                continue
            order = np.argsort(-sel[:, 1], kind="stable")
            tp = sel[order, 2]
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(1.0 - tp)
            recall = tp_cum / max(n_gt, 1)
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            if self._ap_version == "11point":
                ap = float(np.mean([
                    np.max(precision[recall >= t], initial=0.0)
                    for t in np.linspace(0.0, 1.0, 11)]))
            else:
                prev = np.concatenate([[0.0], recall[:-1]])
                ap = float(np.sum((recall - prev) * precision))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0

    def eval(self, executor, eval_program=None):
        if self._match_rows:
            return self._dataset_map()
        return float(np.mean(self._values)) if self._values else 0.0
