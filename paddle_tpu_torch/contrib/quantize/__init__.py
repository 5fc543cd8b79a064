"""Quantization-aware training (counterpart of
``paddle_tpu/contrib/quantize``)."""

from .quantize_transpiler import QuantizeTranspiler  # noqa: F401

__all__ = ["QuantizeTranspiler"]
