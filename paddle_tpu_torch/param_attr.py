"""ParamAttr — per-parameter configuration.

Parity with python/paddle/fluid/param_attr.py (ParamAttr, WeightNormParamAttr).
"""
from .core import unique_name

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        # an Initializer instance
        return ParamAttr(initializer=arg)

    def _name_with_prefix(self, prefix, suffix):
        if self.name is None:
            return unique_name.generate(f"{prefix}.{suffix}")
        return self.name


class WeightNormParamAttr(ParamAttr):
    """Weight-normalized parameter (parity stub: dim attribute recorded; the
    fc/conv layers apply g * v/||v|| when given one)."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
