"""Python-operator sugar on Variable (port of
``paddle_tpu/layers/math_op_patch.py``; parity with
python/paddle/fluid/layers/math_op_patch.py, monkey_patch_variable:22):
``a + b``, ``2 * x``, ``x / 3``, ``x < y`` etc. build the corresponding
elementwise/compare ops in the variable's block.

Scalar operands lower to the ``scale`` op where possible (x*c, x+c,
c-x) and to a broadcast fill_constant tensor otherwise (pow, compares),
matching the reference's create_scalar path.
"""
from ..core import unique_name
from ..core.framework import Variable

_COMPARE_DTYPE = "bool"


def _tmp(ref, dtype=None, lod_level=None, shape=None):
    block = ref.block
    return block.create_var(
        name=unique_name.generate("tmp"),
        dtype=dtype or ref.dtype,
        shape=ref.shape if shape is None else shape,
        lod_level=ref.lod_level if lod_level is None else lod_level)


def _broadcast_shape(sx, sy):
    """Numpy-style broadcast of two static shapes, keeping -1 (dynamic)
    dims dynamic. On a hard mismatch the left shape's dim wins — the
    runtime lowering reports the real error; this is metadata only."""
    import itertools
    out = []
    for a, b in itertools.zip_longest(
            reversed(tuple(sx)), reversed(tuple(sy)), fillvalue=1):
        if a == b or b == 1:
            out.append(a)
        elif a == 1:
            out.append(b)
        elif -1 in (a, b):
            out.append(-1)
        else:
            out.append(a)
    return tuple(reversed(out))


def _scalar_tensor(ref, value):
    """A [1] constant in ref's block (reference create_scalar)."""
    out = ref.block.create_var(name=unique_name.generate("tmp"),
                               dtype=ref.dtype, shape=(1,))
    ref.block.append_op(
        type="fill_constant",
        inputs={}, outputs={"Out": [out.name]},
        attrs={"shape": [1], "dtype": ref.dtype, "value": float(value)})
    return out


def _scale_op(x, scale, bias):
    out = _tmp(x)
    x.block.append_op(type="scale", inputs={"X": [x.name]},
                      outputs={"Out": [out.name]},
                      attrs={"scale": float(scale), "bias": float(bias)})
    return out


def _binary(op_type, x, y, out_like, out_dtype=None):
    """``out_like`` supplies the result's lod/dtype metadata — always
    the bound tensor operand, never a created scalar temp. The result
    SHAPE is the broadcast of both operands' shapes (a ``[d] + [b, d]``
    with the smaller operand on the left must not record ``[d]``)."""
    out = _tmp(out_like, dtype=out_dtype,
               shape=_broadcast_shape(x.shape, y.shape))
    x.block.append_op(type=op_type,
                      inputs={"X": [x.name], "Y": [y.name]},
                      outputs={"Out": [out.name]})
    return out


def _elemwise(method_name, op_type, reverse=False, scalar_fast=None):
    def __impl__(self, other):
        if isinstance(other, (int, float)):
            if scalar_fast is not None:
                return scalar_fast(self, float(other))
            other = _scalar_tensor(self, other)
        elif not isinstance(other, Variable):
            return NotImplemented
        a, b = (other, self) if reverse else (self, other)
        return _binary(op_type, a, b, out_like=self)
    __impl__.__name__ = method_name
    return __impl__


def _compare(method_name, op_type):
    def __impl__(self, other):
        if isinstance(other, (int, float)):
            other = _scalar_tensor(self, other)
        elif not isinstance(other, Variable):
            return NotImplemented
        return _binary(op_type, self, other, out_like=self,
                       out_dtype=_COMPARE_DTYPE)
    __impl__.__name__ = method_name
    return __impl__


def monkey_patch_variable():
    patches = {
        "__add__": _elemwise("__add__", "elementwise_add",
                             scalar_fast=lambda x, c: _scale_op(x, 1.0, c)),
        "__radd__": _elemwise("__radd__", "elementwise_add",
                              scalar_fast=lambda x, c: _scale_op(x, 1.0, c)),
        "__sub__": _elemwise("__sub__", "elementwise_sub",
                             scalar_fast=lambda x, c: _scale_op(x, 1.0, -c)),
        "__rsub__": _elemwise("__rsub__", "elementwise_sub", reverse=True,
                              scalar_fast=lambda x, c: _scale_op(x, -1.0, c)),
        "__mul__": _elemwise("__mul__", "elementwise_mul",
                             scalar_fast=lambda x, c: _scale_op(x, c, 0.0)),
        "__rmul__": _elemwise("__rmul__", "elementwise_mul",
                              scalar_fast=lambda x, c: _scale_op(x, c, 0.0)),
        "__truediv__": _elemwise(
            "__truediv__", "elementwise_div",
            scalar_fast=lambda x, c: _scale_op(x, 1.0 / c, 0.0)),
        "__rtruediv__": _elemwise("__rtruediv__", "elementwise_div",
                                  reverse=True),
        "__div__": _elemwise(
            "__div__", "elementwise_div",
            scalar_fast=lambda x, c: _scale_op(x, 1.0 / c, 0.0)),
        "__rdiv__": _elemwise("__rdiv__", "elementwise_div", reverse=True),
        "__pow__": _elemwise("__pow__", "elementwise_pow"),
        "__rpow__": _elemwise("__rpow__", "elementwise_pow", reverse=True),
        "__neg__": lambda self: _scale_op(self, -1.0, 0.0),
        "__eq__": _compare("__eq__", "equal"),
        "__ne__": _compare("__ne__", "not_equal"),
        "__lt__": _compare("__lt__", "less_than"),
        "__le__": _compare("__le__", "less_equal"),
        "__gt__": _compare("__gt__", "greater_than"),
        "__ge__": _compare("__ge__", "greater_equal"),
    }
    for name, fn in patches.items():
        setattr(Variable, name, fn)
    # __eq__ override removes default hashability; identity hash is right
    # (variables are unique per (block, name))
    Variable.__hash__ = object.__hash__
