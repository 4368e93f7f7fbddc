"""Layer wrappers for the long-tail op set (port of
``paddle_tpu/layers/extras.py``; see ops/extras.py): the reference
exposes most of these only as C++ operators; the wrappers give them the
standard layers surface.
"""
from ..layer_helper import LayerHelper

__all__ = ["minus", "modified_huber_loss", "pad_constant_like",
           "conv_shift", "max_pool2d_with_index", "unpool", "spp",
           "positive_negative_pair", "precision_recall",
           "fake_quantize_abs_max", "fake_dequantize_max_abs"]


def _simple(op_type, ins, outs_shapes, attrs=None):
    helper = LayerHelper(op_type)
    outs = {slot: helper.create_variable_for_type_inference(dt, shape=shape)
            for slot, (shape, dt) in outs_shapes.items()}
    helper.append_op(type=op_type,
                     inputs={k: [v.name] for k, v in ins.items()},
                     outputs={k: [v.name] for k, v in outs.items()},
                     attrs=attrs or {})
    vals = list(outs.values())
    return vals[0] if len(vals) == 1 else tuple(vals)


def minus(x, y):
    """Out = X - Y (reference minus_op.cc)."""
    return _simple("minus", {"X": x, "Y": y},
                   {"Out": (x.shape, x.dtype)})


def modified_huber_loss(x, y):
    """Binary classification loss (reference modified_huber_loss_op.h);
    x [N, 1] raw margin predictions, y {0,1} labels."""
    helper = LayerHelper("modified_huber_loss")
    inter = helper.create_variable_for_type_inference(x.dtype,
                                                      shape=x.shape)
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    shape=x.shape)
    helper.append_op(type="modified_huber_loss",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"IntermediateVal": [inter.name],
                              "Out": [out.name]})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """Pad y up to x's shape with pad_value (reference
    pad_constant_like_op.cc). The single public implementation — an
    identical composition used to shadow it from layers/nn.py."""
    if len(x.shape) != len(y.shape):
        raise ValueError(
            f"pad_constant_like needs same-rank inputs, got {x.shape} "
            f"vs {y.shape}")
    return _simple("pad_constant_like", {"X": x, "Y": y},
                   {"Out": (x.shape, y.dtype)},
                   {"pad_value": float(pad_value)})


def conv_shift(x, y):
    """Circular correlation [B, M] x [B, N] -> [B, M] (reference
    conv_shift_op.cc; NTM-style attention shifting)."""
    return _simple("conv_shift", {"X": x, "Y": y},
                   {"Out": (x.shape, x.dtype)})


def max_pool2d_with_index(input, pool_size, pool_stride=None,
                          pool_padding=0):
    """Max pool returning (out, flat argmax indices) for unpool
    (reference pool_with_index_op.cc)."""
    helper = LayerHelper("max_pool2d_with_index")
    ks = [pool_size, pool_size] if isinstance(pool_size, int) \
        else list(pool_size)
    st = list(pool_stride or ks) if not isinstance(pool_stride, int) \
        else [pool_stride, pool_stride]
    pd = [pool_padding, pool_padding] if isinstance(pool_padding, int) \
        else list(pool_padding)
    b, c, h, w = input.shape
    oh = (h + 2 * pd[0] - ks[0]) // st[0] + 1 if h > 0 else -1
    ow = (w + 2 * pd[1] - ks[1]) // st[1] + 1 if w > 0 else -1
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=[b, c, oh, ow])
    mask = helper.create_variable_for_type_inference(
        "int64", shape=[b, c, oh, ow], stop_gradient=True)
    helper.append_op(type="max_pool2d_with_index",
                     inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"ksize": ks, "strides": st, "paddings": pd})
    return out, mask


def unpool(input, indices, unpooled_height, unpooled_width):
    """Max-unpooling by recorded indices (reference unpool_op.cc)."""
    b, c = input.shape[0], input.shape[1]
    return _simple("unpool", {"X": input, "Indices": indices},
                   {"Out": ([b, c, unpooled_height, unpooled_width],
                            input.dtype)},
                   {"unpooled_height": unpooled_height,
                    "unpooled_width": unpooled_width})


def spp(input, pyramid_height, pooling_type="max"):
    """Spatial pyramid pooling to a fixed-length vector (reference
    spp_op.cc)."""
    b, c = input.shape[0], input.shape[1]
    outlen = ((4 ** pyramid_height - 1) // 3) * c
    return _simple("spp", {"X": input},
                   {"Out": ([b, outlen], input.dtype)},
                   {"pyramid_height": pyramid_height,
                    "pooling_type": pooling_type})


def positive_negative_pair(score, label, qid):
    """Ranking pair statistics grouped by query id (reference
    positive_negative_pair_op.h). Returns (pos, neg, neutral) counts."""
    helper = LayerHelper("positive_negative_pair")
    outs = [helper.create_variable_for_type_inference("float32", shape=[],
                                                      stop_gradient=True)
            for _ in range(3)]
    helper.append_op(
        type="positive_negative_pair",
        inputs={"Score": [score.name], "Label": [label.name],
                "QueryID": [qid.name]},
        outputs={"PositivePair": [outs[0].name],
                 "NegativePair": [outs[1].name],
                 "NeutralPair": [outs[2].name]})
    return tuple(outs)


def precision_recall(indices, labels, class_number, weights=None,
                     states_info=None):
    """Multi-class (macro & micro) precision/recall/F1 (reference
    precision_recall_op.h). Returns (batch_metrics [6],
    accum_metrics [6], accum_states [C, 4])."""
    helper = LayerHelper("precision_recall")
    batch_m = helper.create_variable_for_type_inference(
        "float32", shape=[6], stop_gradient=True)
    accum_m = helper.create_variable_for_type_inference(
        "float32", shape=[6], stop_gradient=True)
    states = helper.create_variable_for_type_inference(
        "float32", shape=[class_number, 4], stop_gradient=True)
    inputs = {"Indices": [indices.name], "Labels": [labels.name]}
    if weights is not None:
        inputs["Weights"] = [weights.name]
    if states_info is not None:
        inputs["StatesInfo"] = [states_info.name]
    helper.append_op(type="precision_recall", inputs=inputs,
                     outputs={"BatchMetrics": [batch_m.name],
                              "AccumMetrics": [accum_m.name],
                              "AccumStatesInfo": [states.name]},
                     attrs={"class_number": class_number})
    return batch_m, accum_m, states


def fake_quantize_abs_max(x, bit_length=8):
    """QAT fake quantization with straight-through gradients (reference
    fake_quantize_op.cc). Returns (quantized, scale)."""
    helper = LayerHelper("fake_quantize_abs_max")
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    shape=x.shape)
    scale = helper.create_variable_for_type_inference(
        "float32", shape=[], stop_gradient=True)
    helper.append_op(type="fake_quantize_abs_max",
                     inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "OutScale": [scale.name]},
                     attrs={"bit_length": bit_length})
    return out, scale


def fake_dequantize_max_abs(x, scale, max_range):
    return _simple("fake_dequantize_max_abs", {"X": x, "Scale": scale},
                   {"Out": (x.shape, x.dtype)},
                   {"max_range": float(max_range)})
