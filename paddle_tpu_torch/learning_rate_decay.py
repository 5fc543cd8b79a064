"""Top-level ``learning_rate_decay`` module name (counterpart of
``paddle_tpu/learning_rate_decay.py``); the schedules live in
``layers/learning_rate_scheduler.py``."""

from .layers.learning_rate_scheduler import *  # noqa: F401,F403
from .layers import learning_rate_scheduler as _lrs

__all__ = list(_lrs.__all__)
