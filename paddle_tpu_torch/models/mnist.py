"""MNIST models (counterpart of ``paddle_tpu/models/mnist.py``): the
recognize_digits MLP and the benchmark's conv net (two conv-pools of 20
and 50 5x5 filters, then a softmax fc)."""

from .. import layers
from ..nets import simple_img_conv_pool

__all__ = ["mlp", "cnn_model"]


def mlp(img, hidden_sizes=(128, 64), class_dim=10):
    """Two-hidden-layer MLP (test_recognize_digits.py:mlp)."""
    h = img
    for size in hidden_sizes:
        h = layers.fc(h, size=size, act="relu")
    return layers.fc(h, size=class_dim, act="softmax")


def cnn_model(data, class_dim=10):
    """conv-pool x2 + fc (benchmark/fluid/models/mnist.py:cnn_model)."""
    conv_pool_1 = simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(conv_pool_2, size=class_dim, act="softmax")
