"""Noise-contrastive estimation loss (port of
``paddle_tpu/layers/nce_impl.py``; reference
paddle/fluid/operators/nce_op.cc): uniform negative sampling inside the
step, drawn with the op's generator."""
from ..layer_helper import LayerHelper


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None):
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr, [num_total_classes, dim],
                                input.dtype)
    b = helper.create_parameter(helper.bias_attr, [num_total_classes],
                                input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0], 1])
    inputs = {"Input": [input.name], "Label": [label.name],
              "Weight": [w.name]}
    if b is not None:
        inputs["Bias"] = [b.name]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    helper.append_op(type="nce", inputs=inputs,
                     outputs={"Cost": [cost.name]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples or 10})
    return cost
