"""AlexNet (counterpart of ``paddle_tpu/models/alexnet.py``; the
reference's ``benchmark/paddle/image/alexnet.py``): 227x227 input, five
convs with ReLU, a cross-channel ``lrn`` after the first two, three 3x3
stride-2 max pools, and 4096 / 4096 / class_dim fcs with dropout 0.5.
bench.py trains it at batch 128; the reference published 334 ms a batch
on a K40m."""

from .. import layers

__all__ = ["alexnet"]


def alexnet(input, class_dim=1000, is_test=False, groups=1):
    conv1 = layers.conv2d(input=input, num_filters=96, filter_size=11,
                          stride=4, padding=1, act="relu")
    norm1 = layers.lrn(input=conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(input=norm1, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv2 = layers.conv2d(input=pool1, num_filters=256, filter_size=5,
                          stride=1, padding=2, groups=groups, act="relu")
    norm2 = layers.lrn(input=conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(input=norm2, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv3 = layers.conv2d(input=pool2, num_filters=384, filter_size=3,
                          stride=1, padding=1, act="relu")
    conv4 = layers.conv2d(input=conv3, num_filters=384, filter_size=3,
                          stride=1, padding=1, groups=groups, act="relu")
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          stride=1, padding=1, groups=groups, act="relu")
    pool5 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2,
                          pool_type="max")

    fc6 = layers.fc(input=pool5, size=4096, act="relu")
    drop6 = layers.dropout(x=fc6, dropout_prob=0.5, is_test=is_test)
    fc7 = layers.fc(input=drop6, size=4096, act="relu")
    drop7 = layers.dropout(x=fc7, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop7, size=class_dim, act="softmax")
