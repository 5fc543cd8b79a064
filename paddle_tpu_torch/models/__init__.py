"""Model builders of the port (counterpart of ``paddle_tpu/models``)."""

from . import ctr_dnn, resnet, transformer  # noqa: F401
