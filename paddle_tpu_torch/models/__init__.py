"""Model builders of the port (counterpart of ``paddle_tpu/models``)."""

from . import (alexnet, ctr_dnn, googlenet, machine_translation,  # noqa: F401
               mnist, resnet, se_resnext, simnet_bow, smallnet,
               stacked_dynamic_lstm, transformer, vgg)
