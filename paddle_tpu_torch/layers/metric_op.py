"""Metric layers (port of ``paddle_tpu/layers/metric_op.py``; parity
with python/paddle/fluid/layers/metric_op.py): ``chunk_eval``,
``accuracy`` and the streaming ``auc``."""
from ..layer_helper import LayerHelper
from .. import initializer as init_mod

__all__ = ["accuracy", "auc", "chunk_eval"]


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk-level precision/recall/F1 for sequence labeling (reference
    layers/nn.py chunk_eval + chunk_eval_op.h). ``input``/``label`` are
    lod_level-1 int sequences of tags encoded
    ``chunk_type * num_tag_types + tag_pos`` under ``chunk_scheme``
    (IOB / IOE / IOBES / plain). Returns (precision, recall, f1,
    num_infer_chunks, num_label_chunks, num_correct_chunks) — feed the
    counts into metrics.ChunkEvaluator for streaming totals."""
    helper = LayerHelper("chunk_eval")

    def _scalar(dtype):
        return helper.create_variable_for_type_inference(
            dtype, shape=[], stop_gradient=True)

    precision, recall, f1 = _scalar("float32"), _scalar("float32"), \
        _scalar("float32")
    num_infer, num_label, num_correct = _scalar("int64"), \
        _scalar("int64"), _scalar("int64")
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input.name], "Label": [label.name]},
        outputs={"Precision": [precision.name], "Recall": [recall.name],
                 "F1-Score": [f1.name],
                 "NumInferChunks": [num_infer.name],
                 "NumLabelChunks": [num_label.name],
                 "NumCorrectChunks": [num_correct.name]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return precision, recall, f1, num_infer, num_label, num_correct


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference accuracy_op.cc): runs top_k then compares."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(
        input.dtype, shape=list(input.shape[:-1]) + [k])
    topk_idx = helper.create_variable_for_type_inference(
        "int64", shape=list(input.shape[:-1]) + [k], stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [topk_out.name],
                              "Indices": [topk_idx.name]},
                     attrs={"k": k})
    acc = helper.create_variable_for_type_inference("float32", shape=[1],
                                                    stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        "int32", shape=[1], stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        "int32", shape=[1], stop_gradient=True)
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out.name],
                             "Indices": [topk_idx.name],
                             "Label": [label.name]},
                     outputs={"Accuracy": [acc.name],
                              "Correct": [correct.name],
                              "Total": [total.name]})
    return acc


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    """Streaming AUC with persistable histogram state (reference
    auc_op.cc)."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(shape=[num_thresholds + 1],
                                             dtype="float32",
                                             persistable=True)
    helper.set_variable_initializer(stat_pos, init_mod.Constant(0.0))
    stat_neg = helper.create_global_variable(shape=[num_thresholds + 1],
                                             dtype="float32",
                                             persistable=True)
    helper.set_variable_initializer(stat_neg, init_mod.Constant(0.0))
    auc_out = helper.create_variable_for_type_inference("float32", shape=[1],
                                                        stop_gradient=True)
    helper.append_op(type="auc",
                     inputs={"Predict": [input.name], "Label": [label.name],
                             "StatPos": [stat_pos.name],
                             "StatNeg": [stat_neg.name]},
                     outputs={"AUC": [auc_out.name],
                              "StatPosOut": [stat_pos.name],
                              "StatNegOut": [stat_neg.name]},
                     attrs={"curve": curve,
                            "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]
