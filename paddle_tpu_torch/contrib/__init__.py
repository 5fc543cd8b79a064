"""contrib package (counterpart of ``paddle_tpu/contrib``): bf16 automatic
mixed precision (``mixed_precision``) and the bf16 inference rewrite
(``float16``)."""

from . import mixed_precision  # noqa: F401
from . import float16  # noqa: F401
from .float16 import Bfloat16Transpiler, Float16Transpiler  # noqa: F401

__all__ = ["mixed_precision", "float16", "Bfloat16Transpiler",
           "Float16Transpiler"]
