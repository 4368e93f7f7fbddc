"""Thin auto-generated layer wrappers for simple ops (port of
``paddle_tpu/layers/ops.py``, which mirrors python/paddle/fluid/layers/
ops.py's layers generated from registered OpProtos): the unary,
elementwise-binary and logical families, ``scale``, ``mean``, ``mul``,
``sum``, the clips, the random ops, ``sampling_id``, ``slice`` and
``shape``."""
import numpy as np

from ..core import framework
from ..layer_helper import LayerHelper

__all__ = []


def _elementwise_shape(x, y, axis):
    xs = list(x.shape)
    return xs


def _make_unary(op_type, attr_names=()):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(
            dtype=x.dtype, shape=x.shape, lod_level=x.lod_level)
        attrs = {k: v for k, v in kwargs.items() if v is not None}
        helper.append_op(type=op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    layer.__doc__ = f"Elementwise {op_type} (reference paddle/fluid/operators/activation_op.cc)."
    return layer


_UNARY = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "softplus", "softsign", "relu", "log",
    "hard_shrink", "thresholded_relu", "relu6", "elu", "leaky_relu",
    "gelu", "swish", "stanh", "brelu", "soft_relu", "hard_sigmoid", "pow",
    "maxout", "logical_not", "cumsum", "sign", "mish",
]
_g = globals()
for _name in _UNARY:
    _g[_name] = _make_unary(_name)
    __all__.append(_name)


def _make_binary(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(
            dtype=x.dtype, shape=_elementwise_shape(x, y, axis),
            lod_level=max(x.lod_level, y.lod_level))
        helper.append_op(type=op_type,
                         inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    layer.__doc__ = (f"{op_type} with fluid axis-broadcast semantics "
                     "(reference paddle/fluid/operators/elementwise_op.h).")
    return layer


for _name in ["elementwise_add", "elementwise_sub", "elementwise_mul",
              "elementwise_div", "elementwise_max", "elementwise_min",
              "elementwise_pow", "elementwise_mod", "elementwise_floordiv"]:
    _g[_name] = _make_binary(_name)
    __all__.append(_name)


def _make_logical(op_type):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(
                dtype="bool", shape=x.shape, stop_gradient=True)
        inputs = {"X": [x.name]}
        if y is not None:
            inputs["Y"] = [y.name]
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={"Out": [out.name]})
        return out
    layer.__name__ = op_type
    return layer


for _name in ["logical_and", "logical_or", "logical_xor"]:
    _g[_name] = _make_logical(_name)
    __all__.append(_name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=x.shape, lod_level=x.lod_level)
    helper.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


__all__.append("scale")


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=[1])
    helper.append_op(type="mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


__all__.append("mean")


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    xs, ys = list(x.shape), list(y.shape)
    out_shape = xs[:x_num_col_dims] + ys[y_num_col_dims:]
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=out_shape)
    helper.append_op(type="mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


__all__.append("mul")


def sum(x):
    from .tensor import sums
    return sums(x if isinstance(x, (list, tuple)) else [x])


__all__.append("sum")


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type="clip", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type="clip_by_norm", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"max_norm": float(max_norm)})
    return out


__all__ += ["clip", "clip_by_norm"]


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ignore_index": ignore_index})
    return out


__all__.append("sigmoid_cross_entropy_with_logits")


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=list(shape))
    helper.append_op(type="uniform_random_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=list(shape))
    helper.append_op(type="gaussian_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=list(shape))
    helper.append_op(type="uniform_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random_batch_size_like(input, shape, dtype="float32",
                                    input_dim_idx=0, output_dim_idx=0,
                                    mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=list(shape))
    helper.append_op(type="gaussian_random_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "mean": mean, "std": std, "seed": seed})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    shape=[x.shape[0]],
                                                    stop_gradient=True)
    helper.append_op(type="sampling_id", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shape = list(input.shape)
    for a, s, e in zip(axes, starts, ends):
        if shape[a] != -1:
            dim = shape[a]
            s2 = max(s + dim, 0) if s < 0 else min(s, dim)
            e2 = max(e + dim, 0) if e < 0 else min(e, dim)
            shape[a] = max(e2 - s2, 0)
    out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    shape=shape)
    helper.append_op(type="slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(
        dtype="int32", shape=[len(input.shape)], stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]})
    return out


__all__ += ["uniform_random_batch_size_like", "gaussian_random",
            "uniform_random", "gaussian_random_batch_size_like",
            "sampling_id", "slice", "shape"]
