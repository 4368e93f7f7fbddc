"""Tensor creation/manipulation layers (port of
``paddle_tpu/layers/tensor.py``; parity with
python/paddle/fluid/layers/tensor.py)."""
import numpy as np

from ..core import framework
from ..layer_helper import LayerHelper
from .. import initializer as init_mod

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "argmin", "argmax", "argsort",
           "ones", "zeros", "reverse", "zeros_like", "ones_like"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(name=helper.name, dtype=dtype,
                                   persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name, param_attr=attr)
    return helper.create_parameter(helper.param_attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape=list(shape), dtype=dtype,
                                        persistable=persistable,
                                        name=name)
    helper.set_variable_initializer(var, init_mod.Constant(value))
    return var


def cast(x, dtype):
    dtype = framework.convert_dtype(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=x.shape, lod_level=x.lod_level)
    helper.append_op(type="cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = list(input[0].shape)
    if shape[axis] != -1:
        try:
            shape[axis] = sum(int(v.shape[axis]) for v in input)
        except TypeError:
            shape[axis] = -1
    out = helper.create_variable_for_type_inference(
        dtype=input[0].dtype, shape=shape,
        lod_level=max(v.lod_level for v in input))
    helper.append_op(type="concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=input[0].dtype, shape=input[0].shape)
    helper.append_op(type="sum", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, framework.Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype, shape=input.shape)
        helper.append_op(type="assign", inputs={"X": [input.name]},
                         outputs={"Out": [output.name]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(arr.dtype), shape=arr.shape)
        helper.append_op(type="assign_value", outputs={"Out": [output.name]},
                         attrs={"values": arr, "dtype": str(arr.dtype)})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=framework.convert_dtype(dtype), shape=list(shape))
    helper.append_op(type="fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape),
                            "dtype": framework.convert_dtype(dtype),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(
        dtype=framework.convert_dtype(dtype), shape=list(shape))
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape),
                            "dtype": framework.convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def _arg_minmax(op_type, x, axis=0):
    helper = LayerHelper(op_type)
    shape = [s for i, s in enumerate(x.shape) if i != axis % len(x.shape)]
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    shape=shape,
                                                    stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    return _arg_minmax("arg_min", x, axis)


def argmax(x, axis=0):
    return _arg_minmax("arg_max", x, axis)


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    shape=input.shape)
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    shape=input.shape,
                                                    stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [ids.name]},
                     attrs={"axis": axis})
    return out, ids


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": 0.0, "bias": 1.0})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type="reverse", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return out
