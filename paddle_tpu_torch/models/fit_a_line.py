"""fit_a_line linear-regression model (port of
``paddle_tpu/models/fit_a_line.py``) — capability parity with the
book chapter-1 example (reference
python/paddle/fluid/tests/book/test_fit_a_line.py:34): one fc of size 1
over the 13 UCI-housing features, square-error cost.
"""
from .. import layers

__all__ = ["build_fit_a_line"]


def build_fit_a_line(x, y):
    """x: float32 [batch, 13]; y: float32 [batch, 1]. Returns
    (y_predict, avg_cost)."""
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    return y_predict, layers.mean(cost)
