"""Sequence layers (port of ``paddle_tpu/layers/sequence_layers.py``).

Parity with the sequence_* functions of python/paddle/fluid/layers/nn.py
plus dynamic_lstm/dynamic_gru/lstm_unit/gru_unit. Variable-length data
flows as SequenceBatch (lod_level>0 vars).
"""
from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
           "lstm_unit", "sequence_pool", "sequence_softmax", "sequence_conv",
           "sequence_expand", "sequence_first_step", "sequence_last_step",
           "sequence_reshape", "sequence_pad", "sequence_unpad",
           "sequence_mask", "sequence_enumerate", "sequence_concat",
           "sequence_slice", "sequence_erase", "lod_reset", "edit_distance"]


def _seq_out(helper, like, dtype=None, shape=None, lod_level=1):
    return helper.create_variable_for_type_inference(
        dtype or like.dtype, shape=shape or like.shape, lod_level=lod_level)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: lod var [.., 4*H] already projected by fc (reference
    python/paddle/fluid/layers/nn.py dynamic_lstm). size = 4*H."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    h = size // 4
    weight = helper.create_parameter(helper.param_attr, [h, 4 * h], dtype)
    bias_size = 7 * h if use_peepholes else 4 * h
    bias = helper.create_parameter(helper.bias_attr, [bias_size], dtype,
                                   is_bias=True)
    hidden = _seq_out(helper, input, dtype,
                      list(input.shape[:-1]) + [h])
    cell = _seq_out(helper, input, dtype, list(input.shape[:-1]) + [h])
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    if c_0 is not None:
        inputs["C0"] = [c_0.name]
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, **kwargs):
    """LSTM with projection: run dynamic_lstm then project hidden states
    (reference dynamic_lstmp). Composed: lstm → fc projection."""
    from . import nn as nn_layers
    hidden, cell = dynamic_lstm(input, size, **kwargs)
    proj = nn_layers.fc(hidden, size=proj_size, bias_attr=False)
    proj.lod_level = 1
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """input: lod var [.., 3*H] projected. size = H."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(helper.param_attr, [size, 3 * size],
                                     dtype)
    bias = helper.create_parameter(helper.bias_attr, [3 * size], dtype,
                                   is_bias=True)
    hidden = _seq_out(helper, input, dtype,
                      list(input.shape[:-1]) + [size])
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    helper.append_op(type="gru", inputs=inputs,
                     outputs={"Hidden": [hidden.name]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """Single-step GRU (reference gru_unit): input [B, 3*H] projected."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    h = size // 3
    weight = helper.create_parameter(helper.param_attr, [h, 3 * h],
                                     input.dtype)
    bias = helper.create_parameter(helper.bias_attr, [3 * h], input.dtype,
                                   is_bias=True)
    out_h = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0], h])
    reset_h = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0], h])
    gate = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0], 2 * h])
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input.name],
                             "HiddenPrev": [hidden.name],
                             "Weight": [weight.name], "Bias": [bias.name]},
                     outputs={"Hidden": [out_h.name],
                              "ResetHiddenPrev": [reset_h.name],
                              "Gate": [gate.name]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return out_h, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single-step LSTM composed like fluid's lstm_unit: concat(x, h) → fc
    to 4H → lstm_unit op."""
    from . import nn as nn_layers
    from . import tensor as tensor_layers
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = int(cell_t_prev.shape[-1])
    concat = tensor_layers.concat([x_t, hidden_t_prev], axis=1)
    fc_out = nn_layers.fc(concat, size=4 * size, param_attr=param_attr,
                          bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(
        x_t.dtype, shape=[x_t.shape[0], size])
    h = helper.create_variable_for_type_inference(
        x_t.dtype, shape=[x_t.shape[0], size])
    helper.append_op(type="lstm_unit",
                     inputs={"X": [fc_out.name],
                             "C_prev": [cell_t_prev.name]},
                     outputs={"C": [c.name], "H": [h.name]},
                     attrs={"forget_bias": forget_bias})
    return h, c


# ---------------------------------------------------------------------------
# sequence_* wrappers
# ---------------------------------------------------------------------------


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0]] + list(input.shape[2:])
        if len(input.shape) > 2 else list(input.shape))
    max_index = helper.create_variable_for_type_inference(
        "int32", shape=out.shape, stop_gradient=True)
    helper.append_op(type="sequence_pool", inputs={"X": [input.name]},
                     outputs={"Out": [out.name],
                              "MaxIndex": [max_index.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input):
    helper = LayerHelper("sequence_first_step")
    shape = [input.shape[0]] + list(input.shape[2:]) \
        if len(input.shape) > 2 else list(input.shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="sequence_first_step", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_last_step(input):
    helper = LayerHelper("sequence_last_step")
    shape = [input.shape[0]] + list(input.shape[2:]) \
        if len(input.shape) > 2 else list(input.shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="sequence_last_step", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_softmax(input, param_attr=None, bias_attr=None,
                     use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = _seq_out(helper, input)
    helper.append_op(type="sequence_softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                [filter_size * d, num_filters], input.dtype)
    out = _seq_out(helper, input, None,
                   list(input.shape[:-1]) + [num_filters])
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2),
                            "contextStride": filter_stride})
    bias = helper.create_parameter(helper.bias_attr, [num_filters],
                                   input.dtype, is_bias=True)
    if bias is not None:
        out2 = _seq_out(helper, out, None, out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [bias.name]},
                         outputs={"Out": [out2.name]}, attrs={"axis": -1})
        out = out2
    return helper.append_activation(out)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=[y.shape[0], y.shape[1] if len(y.shape) > 1 else -1]
        + list(x.shape[1:]), lod_level=1)
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = _seq_out(helper, input, None,
                   [input.shape[0], -1, new_dim])
    helper.append_op(type="sequence_reshape", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"new_dim": new_dim})
    return out


def sequence_pad(x, pad_value=None, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    length = helper.create_variable_for_type_inference(
        "int64", shape=[x.shape[0]], stop_gradient=True)
    helper.append_op(type="sequence_pad", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Length": [length.name]})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = _seq_out(helper, x)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x.name], "Length": [length.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(
        dtype, shape=[x.shape[0], maxlen if maxlen else -1],
        stop_gradient=True)
    helper.append_op(type="sequence_mask", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": dtype})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = _seq_out(helper, input, "int64",
                   list(input.shape) + [win_size])
    helper.append_op(type="sequence_enumerate", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    last = sum(int(v.shape[-1]) for v in input)
    out = _seq_out(helper, input[0], None,
                   list(input[0].shape[:-1]) + [last])
    helper.append_op(type="sequence_concat",
                     inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = _seq_out(helper, input)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Length": [length.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = _seq_out(helper, input)
    helper.append_op(type="sequence_erase", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"tokens": list(tokens)})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset")
    out = _seq_out(helper, x)
    inputs = {"X": [x.name]}
    if y is not None:
        inputs["Y"] = [y.name]
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None):
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        input = sequence_erase(input, ignored_tokens)
        label = sequence_erase(label, ignored_tokens)
    out = helper.create_variable_for_type_inference(
        "float32", shape=[input.shape[0], 1], stop_gradient=True)
    seq_num = helper.create_variable_for_type_inference(
        "int64", shape=[1], stop_gradient=True)
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input.name], "Refs": [label.name]},
                     outputs={"Out": [out.name],
                              "SequenceNum": [seq_num.name]},
                     attrs={"normalized": normalized})
    return out, seq_num
