"""MNIST models (port of ``paddle_tpu/models/mnist.py``; parity with
benchmark/fluid/models/mnist.py): the cnn_model (two conv+pool groups
then fc) and the book's MLP."""
from .. import layers
from ..nets import simple_img_conv_pool

__all__ = ["cnn_model", "mlp_model"]


def cnn_model(data, label, class_num=10):
    """reference benchmark/fluid/models/mnist.py cnn_model: conv5x5x20 →
    pool2 → conv5x5x50 → pool2 → fc10+softmax; returns (avg_loss, acc,
    prediction)."""
    conv_pool_1 = simple_img_conv_pool(input=data, filter_size=5,
                                       num_filters=20, pool_size=2,
                                       pool_stride=2, act="relu")
    conv_pool_2 = simple_img_conv_pool(input=conv_pool_1, filter_size=5,
                                       num_filters=50, pool_size=2,
                                       pool_stride=2, act="relu")
    predict = layers.fc(input=conv_pool_2, size=class_num, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, predict


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
