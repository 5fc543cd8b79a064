"""Program rewrites (counterpart of ``paddle_tpu/transpiler``).  Only the
int8 inference pass, ``quantize_inference``, is ported."""

from .quantize_pass import QUANT_SUFFIX, SCALE_SUFFIX, quantize_inference

__all__ = ["quantize_inference", "QUANT_SUFFIX", "SCALE_SUFFIX"]
