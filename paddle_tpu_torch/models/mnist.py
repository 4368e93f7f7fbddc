"""MNIST models (port of ``paddle_tpu/models/mnist.py``; parity with
benchmark/fluid/models/mnist.py): the book's MLP. ``cnn_model`` needs
conv2d and pool2d, ported with ROADMAP.md item 'Conv nets and the
transpilers'."""
from .. import layers
from ..waiting import CONV, module_getattr

__all__ = ["mlp_model"]

WAITING = {"cnn_model": CONV}
__getattr__ = module_getattr(__name__, WAITING)


def mlp_model(data, label, hidden_sizes=(128, 64), class_num=10):
    """The Deep Learning 101 recognize_digits MLP (reference
    python/paddle/fluid/tests/book/test_recognize_digits.py)."""
    h = data
    for size in hidden_sizes:
        h = layers.fc(input=h, size=size, act="relu")
    predict = layers.fc(input=h, size=class_num, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, predict
