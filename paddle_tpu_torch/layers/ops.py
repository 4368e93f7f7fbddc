"""Thin auto-generated layer wrappers for simple ops (port of
``paddle_tpu/layers/ops.py``): the elementwise layers whose rules the
port registers, ``scale`` and ``mean``; the rest of the family lands
with their rules."""
from ..layer_helper import LayerHelper

__all__ = []


def _elementwise_shape(x, y, axis):
    xs = list(x.shape)
    return xs


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


_g = globals()
for _name in ["elementwise_add", "elementwise_mul", "elementwise_div",
              "elementwise_max"]:
    _g[_name] = _make_binary(_name)
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


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=[1])
    helper.append_op(type="mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


__all__ += ["scale", "mean"]
