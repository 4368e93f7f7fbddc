"""SE-ResNeXt (port of ``paddle_tpu/models/se_resnext.py``) — capability
parity with the reference-era SE_ResNeXt image models (grouped-
convolution ResNeXt bottlenecks with squeeze-and-excitation channel
gating). Grouped convs run as cuDNN grouped convolutions on the card.
"""
from .. import layers

__all__ = ["build_se_resnext", "SE_RESNEXT_DEPTHS"]

SE_RESNEXT_DEPTHS = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def _conv_bn(input, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def _squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input=input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool,
                        size=max(1, num_channels // reduction_ratio),
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    gate = layers.reshape(excitation, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(x=input, y=gate)


def _shortcut(input, ch_out, stride):
    ch_in = int(input.shape[1])
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride)
    return input


def _bottleneck(input, num_filters, stride, cardinality, reduction_ratio):
    conv0 = _conv_bn(input, num_filters, 1, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride,
                     groups=cardinality, act="relu")
    conv2 = _conv_bn(conv1, num_filters * 2, 1)
    se = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride)
    return layers.elementwise_add(x=short, y=se, act="relu")


def build_se_resnext(input, class_dim=1000, depth=50, cardinality=32,
                     reduction_ratio=16):
    """input: float32 [batch, 3, H, W] NCHW. Returns softmax probs
    [batch, class_dim] (SE-ResNeXt-50/101/152 32x4d)."""
    stages = SE_RESNEXT_DEPTHS[depth]
    conv = _conv_bn(input, 64, 7, stride=2, act="relu")
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max")
    num_filters = [128, 256, 512, 1024]
    for stage, count in enumerate(stages):
        for i in range(count):
            conv = _bottleneck(conv, num_filters[stage],
                               stride=2 if i == 0 and stage != 0 else 1,
                               cardinality=cardinality,
                               reduction_ratio=reduction_ratio)
    pool = layers.pool2d(input=conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.2)
    return layers.fc(input=drop, size=class_dim, act="softmax")
