"""High-level neural network layers (port of ``paddle_tpu/layers/nn.py``).

This slice carries the layers the Llama forward program uses: ``fc``,
``embedding`` and ``reshape``, copied with only the sharding annotation
type changed. The rest of the reference module lands with the slices
that port its ops. Each layer builds Program ops; shapes are inferred in
Python (batch dims stay -1) so parameters can be sized.
"""
import numpy as np

from ..layer_helper import LayerHelper
from ..sharding import PartitionSpec as P

__all__ = ["fc", "embedding", "reshape"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, use_mkldnn=False, name=None):
    """Fully connected layer (reference python/paddle/fluid/layers/nn.py
    fc): out = act(sum_i(x_i @ w_i) + b)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input("input").dtype if not isinstance(input, (list, tuple)) \
        else input[0].dtype
    inputs = helper.multiple_input()
    param_attrs = helper.param_attr
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_dims = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, [in_dims, size], dtype)
        out_shape = list(inp.shape[:num_flatten_dims]) + [size]
        tmp = helper.create_variable_for_type_inference(
            dtype, shape=out_shape,
            lod_level=inp.lod_level if num_flatten_dims == 1 else 0)
        helper.append_op(type="mul",
                         inputs={"X": [inp.name], "Y": [w.name]},
                         outputs={"Out": [tmp.name]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype, shape=mul_results[0].shape,
            lod_level=mul_results[0].lod_level)
        helper.append_op(type="sum",
                         inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    bias = helper.create_parameter(helper.bias_attr, [size], dtype,
                                   is_bias=True)
    pre_act = helper.append_bias_op(pre_bias, bias)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (reference lookup_table_op.cc).

    ``is_sparse`` is accepted for parity (the lookup is a gather).

    ``is_distributed`` annotates the table ``P('mp', None)`` as the
    reference does (row-sharded over a mesh 'mp' axis); nothing reads
    the annotation until multi-device execution is ported.
    """
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    if is_distributed:
        w.sharding = P(*(("mp",) + (None,) * (len(size) - 1)))
    out_shape = list(input.shape)
    if out_shape and out_shape[-1] == 1:
        out_shape = out_shape[:-1]
    out_shape = out_shape + [size[1]]
    out = helper.create_variable_for_type_inference(
        dtype, shape=out_shape, lod_level=input.lod_level)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"padding_idx": pad, "is_sparse": is_sparse})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out_shape = list(shape)
    known = [s for s in out_shape if s not in (-1,)]
    # resolve 0 (copy dim) for shape inference
    resolved = [x.shape[i] if s == 0 else s for i, s in enumerate(out_shape)]
    if -1 in resolved:
        total = int(np.prod([s for s in x.shape])) if -1 not in x.shape else -1
        if total != -1:
            rest = int(np.prod([s for s in resolved if s != -1]))
            resolved = [total // rest if s == -1 else s for s in resolved]
    out = helper.create_variable_for_type_inference(x.dtype, shape=resolved)
    helper.append_op(type="reshape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)

