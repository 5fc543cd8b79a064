"""Layers of the serving slice (counterpart of ``paddle_tpu/layers``)."""

from .cnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
