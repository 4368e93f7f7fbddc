"""Parameter initializers.

Parity with python/paddle/fluid/initializer.py — each initializer appends
an init op to the *startup program* for the given variable; running the
startup Executor materializes all parameters on device, exactly like
fluid's two-program idiom.
"""
import math

import numpy as np

from .core import framework

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "BilinearInitializer", "force_init_on_cpu",
           "init_on_cpu"]


def force_init_on_cpu():  # fluid-compat; meaningless under XLA
    return False


import contextlib


@contextlib.contextmanager
def init_on_cpu():
    yield


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fans(var):
        """Fan-in/out matching fluid's conventions: fc weights are
        [in, out]; conv kernels are fluid OIHW [cout, cin/g, k...] so the
        receptive field is shape[2:], fan_in = cin*prod(k), fan_out =
        cout*prod(k) (reference python/paddle/fluid/initializer.py
        _compute_fans)."""
        shape = var.shape
        if len(shape) < 2:
            n = int(shape[0]) if shape else 1
            return n, n
        if len(shape) == 2:
            return int(shape[0]), int(shape[1])
        receptive = int(np.prod(shape[2:]))
        fan_in = int(shape[1]) * receptive
        fan_out = int(shape[0]) * receptive
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(type="fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(type="uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": float(self.low), "max": float(self.high),
                               "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(type="gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc), "std": float(self.scale),
                               "seed": self.seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(type="truncated_gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc), "std": float(self.scale),
                               "seed": self.seed})


class XavierInitializer(Initializer):
    """Glorot init (reference python/paddle/fluid/initializer.py
    XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fan_in, fan_out = self._fans(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        fan_out = self.fan_out if self.fan_out is not None else fan_out
        if self.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fan_in + fan_out))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He init (reference MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fan_in, _ = self._fans(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fan_in)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """Bilinear upsampling kernels for conv_transpose (reference
    BilinearInitializer). Computes the weight on host and embeds it."""

    def __call__(self, var, block):
        # conv2d_transpose weights are fluid IOHW: [cin, cout/g, kh, kw]
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs 4D weights")
        kh, kw = shape[2], shape[3]
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype=np.float32)
        for i in range(kh):
            for j in range(kw):
                v = (1 - abs(j / f - c)) * (1 - abs(i / f - c))
                for ch in range(min(shape[0], shape[1])):
                    w[ch, ch, i, j] = v
        block.append_op(type="assign_value", outputs={"Out": [var.name]},
                        attrs={"values": w, "dtype": var.dtype})


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(type="assign_value", outputs={"Out": [var.name]},
                        attrs={"values": self.value, "dtype": var.dtype})


# fluid short aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
