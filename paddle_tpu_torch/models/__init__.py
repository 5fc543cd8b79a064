"""Model builders of the port (counterpart of ``paddle_tpu/models``)."""

from . import resnet, transformer  # noqa: F401
