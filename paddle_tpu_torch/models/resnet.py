"""ResNet for ImageNet/cifar10 (counterpart of
``paddle_tpu/models/resnet.py``; reference
``benchmark/fluid/models/resnet.py`` resnet_imagenet/resnet_cifar10 —
bottleneck + basicblock variants).

NCHW at the API, as the JAX package builds it; ``transpiler.
convert_to_nhwc`` turns the trunk NHWC and ``transpiler.fuse_conv_bn``
fuses the bottlenecks' 1x1 convs with their batch norms (kernels #8-#11).
Batch-norm statistics update inside each training step.
"""

from .. import layers

__all__ = ["resnet_imagenet", "resnet_cifar10"]


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = layers.conv2d(
        input=input, num_filters=ch_out, filter_size=filter_size,
        stride=stride, padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def _shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_test=is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = _shortcut(input, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = _shortcut(input, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def _layer_warp(block_func, input, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_out, stride, is_test=is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test)
    return res_out


_DEPTH_CFG = {
    18: ([2, 2, 2, 2], basicblock),
    34: ([3, 4, 6, 3], basicblock),
    50: ([3, 4, 6, 3], bottleneck),
    101: ([3, 4, 23, 3], bottleneck),
    152: ([3, 8, 36, 3], bottleneck),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    cfg, block_func = _DEPTH_CFG[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = _layer_warp(block_func, pool1, 64, cfg[0], 1, is_test=is_test)
    res2 = _layer_warp(block_func, res1, 128, cfg[1], 2, is_test=is_test)
    res3 = _layer_warp(block_func, res2, 256, cfg[2], 2, is_test=is_test)
    res4 = _layer_warp(block_func, res3, 512, cfg[3], 2, is_test=is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    if (depth - 2) % 6:
        raise ValueError("resnet_cifar10 depth must be 6n + 2, got %d"
                         % depth)
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = _layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = _layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = _layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")
