"""VGG-16 with batch norm and dropout (counterpart of
``paddle_tpu/models/vgg.py``; the reference's
``benchmark/fluid/models/vgg.py`` ``vgg16_bn_drop``): five
``img_conv_group`` blocks of 2, 2, 3, 3, 3 convs (64 to 512 filters, each
conv with batch norm + ReLU and dropout 0.3 / 0.4 between convs), a 2x2
max pool after each, then fc 512, batch norm, fc 512 and the classifier,
with dropout 0.5."""

from .. import layers
from ..nets import img_conv_group

__all__ = ["vgg16_bn_drop"]


def vgg16_bn_drop(input, class_dim=1000, is_test=False):
    def conv_block(ipt, num_filter, groups, dropouts):
        return img_conv_group(
            input=ipt,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim, act="softmax")
