"""ResNet family (He et al. 2015), port of ``paddle_tpu/models/resnet.py``
— capability parity with the reference's benchmark model
(benchmark/fluid/models/resnet.py: resnet_imagenet, resnet_cifar10)
including its depth table.

One `_residual` builder handles both the basic (2x conv3) and bottleneck
(1-3-1) forms, and the nets iterate a (width, count, stride) table.

``layout``: "NCHW" (fluid parity) or "NHWC" — the input is transposed
ONCE at the stem and every conv / pool / batch_norm then runs
channels-last (on the card, cuDNN on the channels-last view of each
activation, with no relayout copy per conv). The fc after the global
average pool sees [N, C] either way, so both layouts compute the same
model (same parameters, same loss).
"""
from .. import layers

__all__ = ["resnet_imagenet", "resnet_cifar10", "resnet50"]

# depth -> (block counts per stage, bottlenecked?) — mirrors the
# reference's config table (including its [2, 2, 2, 1] quirk for 18).
_IMAGENET_DEPTHS = {
    18: ([2, 2, 2, 1], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}
_STAGE_WIDTHS = (64, 128, 256, 512)


def _conv_bn(x, channels, ksize, stride=1, act="relu", layout="NCHW"):
    """conv (no bias — BN's beta serves) + batch_norm, SAME padding."""
    y = layers.conv2d(input=x, num_filters=channels, filter_size=ksize,
                      stride=stride, padding=(ksize - 1) // 2, act=None,
                      bias_attr=False, data_format=layout)
    return layers.batch_norm(input=y, act=act, data_layout=layout)


def _residual(x, width, stride, bottlenecked, layout="NCHW"):
    """One residual unit; the shortcut is a 1x1 projection whenever the
    unit changes shape (channels or spatial), identity otherwise."""
    out_channels = width * 4 if bottlenecked else width
    c_axis = 1 if layout == "NCHW" else 3
    if int(x.shape[c_axis]) != out_channels or stride != 1:
        short = _conv_bn(x, out_channels, 1, stride, act=None,
                         layout=layout)
    else:
        short = x
    if bottlenecked:
        y = _conv_bn(x, width, 1, stride, layout=layout)
        y = _conv_bn(y, width, 3, layout=layout)
        y = _conv_bn(y, out_channels, 1, act=None, layout=layout)
    else:
        y = _conv_bn(x, width, 3, stride, layout=layout)
        y = _conv_bn(y, width, 3, act=None, layout=layout)
    return layers.elementwise_add(x=short, y=y, act="relu")


def _stage(x, width, count, stride, bottlenecked, layout="NCHW"):
    for i in range(count):
        x = _residual(x, width, stride if i == 0 else 1, bottlenecked,
                      layout=layout)
    return x


def resnet_imagenet(input, class_num=1000, depth=50, layout="NCHW"):
    """7x7/2 stem -> 3x3/2 maxpool -> 4 stages -> global avg -> fc.
    ``input`` is NCHW regardless of ``layout`` (dataset/feed parity);
    layout="NHWC" transposes once here and runs the body
    channels-minor."""
    counts, bottlenecked = _IMAGENET_DEPTHS[depth]
    x = input
    if layout == "NHWC":
        x = layers.transpose(x, perm=[0, 2, 3, 1])
    x = _conv_bn(x, 64, 7, stride=2, layout=layout)
    x = layers.pool2d(input=x, pool_type="max", pool_size=3,
                      pool_stride=2, pool_padding=1, data_format=layout)
    for width, count in zip(_STAGE_WIDTHS, counts):
        x = _stage(x, width, count, stride=1 if width == 64 else 2,
                   bottlenecked=bottlenecked, layout=layout)
    x = layers.pool2d(input=x, pool_type="avg", pool_size=7,
                      global_pooling=True, data_format=layout)
    return layers.fc(input=x, size=class_num, act="softmax")


def resnet_cifar10(input, class_num=10, depth=32, layout="NCHW"):
    """The 6n+2 cifar form: 3x3 stem, three basic-block stages of n at
    widths 16/32/64, global average pool, fc."""
    if (depth - 2) % 6 != 0:
        raise ValueError(f"cifar resnet depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    x = input
    if layout == "NHWC":
        x = layers.transpose(x, perm=[0, 2, 3, 1])
    x = _conv_bn(x, 16, 3, layout=layout)
    for width in (16, 32, 64):
        x = _stage(x, width, n, stride=1 if width == 16 else 2,
                   bottlenecked=False, layout=layout)
    x = layers.pool2d(input=x, pool_type="avg", pool_size=8,
                      pool_stride=1, global_pooling=True,
                      data_format=layout)
    return layers.fc(input=x, size=class_num, act="softmax")


def resnet50(data, label, class_num=1000, layout="NCHW"):
    """The benchmark entry: (avg_cost, accuracy, predictions)."""
    predict = resnet_imagenet(data, class_num=class_num, depth=50,
                              layout=layout)
    cost = layers.cross_entropy(input=predict, label=label)
    return layers.mean(cost), layers.accuracy(input=predict,
                                              label=label), predict
