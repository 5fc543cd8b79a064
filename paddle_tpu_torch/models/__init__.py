"""Model builders of the port (counterpart of ``paddle_tpu/models``)."""

from . import transformer  # noqa: F401
