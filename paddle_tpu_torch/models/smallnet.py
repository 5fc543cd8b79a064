"""SmallNet (counterpart of ``paddle_tpu/models/smallnet.py``; the
reference's cifar-scale benchmark topology
``benchmark/paddle/image/smallnet_mnist_cifar.py``): 32x32 input, three
5/5/3 convs each followed by a 3x3 stride-2 pool (max, then two avg),
then 64- and class_dim-wide fcs.  bench.py trains it at batch 256; the
reference published 33.1 ms a batch on a K40m."""

from .. import layers

__all__ = ["smallnet"]


def smallnet(input, class_dim=10, is_test=False):
    conv1 = layers.conv2d(input=input, num_filters=32, filter_size=5,
                          stride=1, padding=2, act="relu")
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max")

    conv2 = layers.conv2d(input=pool1, num_filters=32, filter_size=5,
                          stride=1, padding=2, act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="avg")

    conv3 = layers.conv2d(input=pool2, num_filters=64, filter_size=3,
                          stride=1, padding=1, act="relu")
    pool3 = layers.pool2d(input=conv3, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="avg")

    fc1 = layers.fc(input=pool3, size=64, act="relu")
    return layers.fc(input=fc1, size=class_dim, act="softmax")
