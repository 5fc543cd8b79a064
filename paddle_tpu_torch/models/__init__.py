"""Model builders of the port (counterpart of ``paddle_tpu/models``)."""

from . import (alexnet, ctr_dnn, googlenet, resnet,  # noqa: F401
               se_resnext, smallnet, transformer, vgg)
