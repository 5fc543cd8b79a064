"""GoogLeNet, Inception v1 (counterpart of
``paddle_tpu/models/googlenet.py``; the reference's
``benchmark/paddle/image/googlenet.py``): 224x224 input, a 7x7 stride-2
stem and a 1x1 -> 3x3 stage, nine inception blocks (four towers, 1x1 /
1x1 -> 3x3 / 1x1 -> 5x5 / 3x3 max pool -> 1x1, concatenated on the
channels) with ceil-mode 3x3 stride-2 max pools between stages, a 7x7
average pool, dropout 0.4 and one softmax head (the benchmark leaves out
the two auxiliary losses).  Every conv carries ReLU.  bench.py trains it
at batch 128; the reference published 1149 ms a batch on a K40m."""

from .. import layers

__all__ = ["googlenet_v1"]


def _conv(input, ch, filter_size, stride=1, padding=0):
    return layers.conv2d(input=input, num_filters=ch,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act="relu")


def inception(input, filter1, filter3R, filter3, filter5R, filter5, proj):
    """One Inception v1 block: 1x1 / 1x1->3x3 / 1x1->5x5 / 3x3pool->1x1."""
    tower1 = _conv(input, filter1, 1)
    tower3 = _conv(_conv(input, filter3R, 1), filter3, 3, padding=1)
    tower5 = _conv(_conv(input, filter5R, 1), filter5, 5, padding=2)
    pool = layers.pool2d(input=input, pool_size=3, pool_stride=1,
                         pool_padding=1, pool_type="max")
    towerp = _conv(pool, proj, 1)
    return layers.concat([tower1, tower3, tower5, towerp], axis=1)


def googlenet_v1(input, class_dim=1000, is_test=False):
    # stage 1
    conv1 = _conv(input, 64, 7, stride=2, padding=3)
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_type="max", ceil_mode=True)
    # stage 2
    conv2 = _conv(_conv(pool1, 64, 1), 192, 3, padding=1)
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2,
                          pool_type="max", ceil_mode=True)
    # stage 3
    ince3a = inception(pool2, 64, 96, 128, 16, 32, 32)
    ince3b = inception(ince3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(input=ince3b, pool_size=3, pool_stride=2,
                          pool_type="max", ceil_mode=True)
    # stage 4
    ince4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    ince4b = inception(ince4a, 160, 112, 224, 24, 64, 64)
    ince4c = inception(ince4b, 128, 128, 256, 24, 64, 64)
    ince4d = inception(ince4c, 112, 144, 288, 32, 64, 64)
    ince4e = inception(ince4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(input=ince4e, pool_size=3, pool_stride=2,
                          pool_type="max", ceil_mode=True)
    # stage 5
    ince5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    ince5b = inception(ince5a, 384, 192, 384, 48, 128, 128)
    pool5 = layers.pool2d(input=ince5b, pool_size=7, pool_stride=7,
                          pool_type="avg")

    drop = layers.dropout(x=pool5, dropout_prob=0.4, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")
