"""SE-ResNeXt (counterpart of ``paddle_tpu/models/se_resnext.py``; the
reference's ``benchmark/fluid/models/se_resnext.py``, the model of
BASELINE.json's multi-device configuration).

Each bottleneck is a 1x1 conv, a 3x3 grouped conv (``cardinality``
groups) and a 1x1 conv to twice its width, each with batch norm, then a
squeeze-and-excitation: global average pool, an fc down by
``reduction_ratio`` with ReLU, an fc back up with sigmoid, and the
channel-wise product with the block's output (``elementwise_mul`` at
axis 0 broadcasts the [N, C] excitation over H and W); a residual add
with ReLU closes it.  Depth 152 starts with three 3x3 convs, 50 and 101
with one 7x7.  ``transpiler.fuse_conv_bn`` fuses the 1x1 convs that read
a batch norm (kernels #8 and #9)."""

from .. import layers

__all__ = ["SE_ResNeXt", "se_resnext_50"]


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input=input, pool_size=0, pool_type="avg",
                         global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def _shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride, is_test=is_test)
    return layers.elementwise_add(x=short, y=scale, act="relu")


_DEPTH_CFG = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def SE_ResNeXt(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False):
    cfg = _DEPTH_CFG[depth]
    if depth == 152:
        conv = conv_bn_layer(input, 64, 3, stride=2, act="relu",
                             is_test=is_test)
        conv = conv_bn_layer(conv, 64, 3, act="relu", is_test=is_test)
        conv = conv_bn_layer(conv, 128, 3, act="relu", is_test=is_test)
    else:
        conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                             is_test=is_test)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max")

    num_filters_list = [128, 256, 512, 1024]
    for block in range(len(cfg)):
        for i in range(cfg[block]):
            conv = bottleneck_block(
                conv, num_filters_list[block],
                2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio, is_test=is_test)

    pool = layers.pool2d(input=conv, pool_size=7, pool_type="avg",
                         global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def se_resnext_50(input, class_dim=1000, is_test=False):
    return SE_ResNeXt(input, class_dim=class_dim, depth=50, is_test=is_test)
