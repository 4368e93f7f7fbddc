"""Thin auto-generated layer wrappers for simple ops (port of
``paddle_tpu/layers/ops.py``). This slice generates the elementwise
layers whose rules it registers; the rest of the family lands with
their rules."""
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
for _name in ["elementwise_add", "elementwise_mul"]:
    _g[_name] = _make_binary(_name)
    __all__.append(_name)
