"""WeightedAverage (port of ``paddle_tpu/average.py``; reference
python/paddle/fluid/average.py:40)."""
import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        value = np.asarray(value, dtype=np.float64)
        if value.ndim > 1 or (value.ndim == 1 and value.shape[0] != 1):
            raise ValueError("add() expects a scalar value")
        v = float(value.reshape(-1)[0])
        w = float(weight)
        if self.numerator is None:
            self.numerator, self.denominator = 0.0, 0.0
        self.numerator += v * w
        self.denominator += w

    def eval(self):
        if not self.denominator:
            raise ValueError(
                "there is no data in WeightedAverage; call add() first")
        return self.numerator / self.denominator
