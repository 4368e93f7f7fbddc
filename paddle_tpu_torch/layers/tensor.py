"""Tensor layers (port of ``paddle_tpu/layers/tensor.py``): ``cast``,
behind ``Variable.astype``; the rest of the module lands with its
ops."""
from ..core import framework
from ..layer_helper import LayerHelper

__all__ = ["cast"]


def cast(x, dtype):
    dtype = framework.convert_dtype(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=x.shape, lod_level=x.lod_level)
    helper.append_op(type="cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out

