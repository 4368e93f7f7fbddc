"""Hierarchical sigmoid (port of ``paddle_tpu/layers/hsig_impl.py``;
reference paddle/fluid/operators/hierarchical_sigmoid_op.cc) using a
complete binary tree over classes. The code/path tables are static per
num_classes, so the whole loss is dense gathers + a [batch, depth, dim]
contraction, with no per-sample control flow."""
from ..layer_helper import LayerHelper


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr, [num_classes - 1, dim],
                                input.dtype)
    b = helper.create_parameter(helper.bias_attr, [num_classes - 1],
                                input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=[input.shape[0], 1])
    inputs = {"X": [input.name], "Label": [label.name], "W": [w.name]}
    if b is not None:
        inputs["Bias"] = [b.name]
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"num_classes": num_classes})
    return out
