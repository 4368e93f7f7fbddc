"""Composite networks (port of ``paddle_tpu/nets.py``; parity with
python/paddle/fluid/nets.py): simple_img_conv_pool, img_conv_group,
sequence_conv_pool, glu and scaled_dot_product_attention, copied from
the reference.
"""
from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   data_format="NCHW"):
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else \
            [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_act,
                            data_format=data_format)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act,
                                    data_layout=data_format)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         data_format=data_format)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Composed multi-head attention over [batch, len, dim] inputs
    (reference python/paddle/fluid/nets.py scaled_dot_product_attention)."""
    if num_heads > 1:
        d = int(queries.shape[-1])

        def split_heads(x):
            reshaped = layers.reshape(
                x, shape=[0, 0, num_heads, int(x.shape[-1]) // num_heads])
            return layers.transpose(reshaped, perm=[0, 2, 1, 3])

        q, k, v = map(split_heads, (queries, keys, values))
    else:
        q, k, v = queries, keys, values
    scale = float(int(q.shape[-1]) ** -0.5)
    product = layers.matmul(q, k, transpose_y=True, alpha=scale)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    if num_heads > 1:
        ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
        ctx = layers.reshape(ctx, shape=[0, 0, int(queries.shape[-1])])
    return ctx
