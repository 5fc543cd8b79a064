"""contrib package (counterpart of ``paddle_tpu/contrib``): bf16 automatic
mixed precision (``mixed_precision``), the bf16 inference rewrite
(``float16``), and the high-level ``Trainer`` (with its events) and
``Inferencer``."""

from . import mixed_precision  # noqa: F401
from . import float16  # noqa: F401
from .float16 import Bfloat16Transpiler, Float16Transpiler  # noqa: F401
from . import trainer  # noqa: F401
from . import inferencer  # noqa: F401
from .trainer import (BeginEpochEvent, BeginStepEvent,  # noqa: F401
                      CheckpointConfig, EndEpochEvent, EndStepEvent, Trainer)
from .inferencer import Inferencer  # noqa: F401

__all__ = ["mixed_precision", "float16", "Bfloat16Transpiler",
           "Float16Transpiler", "trainer", "inferencer", "Trainer",
           "Inferencer", "CheckpointConfig", "BeginEpochEvent",
           "EndEpochEvent", "BeginStepEvent", "EndStepEvent"]
