"""VGG16 (port of ``paddle_tpu/models/vgg.py``) — parity with
benchmark/fluid/models/vgg.py.

``layout="NHWC"`` runs the conv stack channels-last (see
models/resnet.py): the input transposes once at the stem.
CAVEAT: unlike ResNet (global pool -> [N, C] either way), VGG flattens
a 7x7x512 feature map into fc1, so the flatten ORDER differs between
layouts — an NCHW-trained checkpoint's fc1 weights do not load into an
NHWC graph (convs/bns are portable; fresh training is unaffected).
"""
from .. import layers
from ..nets import img_conv_group

__all__ = ["vgg16_bn_drop", "vgg16"]


def vgg16_bn_drop(input, class_num=1000, fc_size=4096, layout="NCHW"):
    """reference benchmark/fluid/models/vgg.py vgg16_bn_drop."""

    def conv_block(inp, num_filter, groups, dropouts):
        return img_conv_group(input=inp, pool_size=2, pool_stride=2,
                              conv_num_filter=[num_filter] * groups,
                              conv_filter_size=3, conv_act="relu",
                              conv_with_batchnorm=True,
                              conv_batchnorm_drop_rate=dropouts,
                              pool_type="max", data_format=layout)

    if layout == "NHWC":
        input = layers.transpose(input, perm=[0, 2, 3, 1])
    conv1 = conv_block(input, 64, 2, [0.3, 0.0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0.0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0.0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0.0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0.0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=fc_size, act=None)
    bn = layers.batch_norm(input=fc1, act="relu")
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=fc_size, act=None)
    predict = layers.fc(input=fc2, size=class_num, act="softmax")
    return predict


def vgg16(data, label, class_num=1000, fc_size=4096, layout="NCHW"):
    predict = vgg16_bn_drop(data, class_num, fc_size, layout=layout)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, predict
