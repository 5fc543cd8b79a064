"""Program rewrites (counterpart of ``paddle_tpu/transpiler``): the int8
inference pass ``quantize_inference``, the whole-trunk NHWC layout pass
``convert_to_nhwc`` and the conv+BN fusion pass ``fuse_conv_bn``."""

from .fusion import fuse_conv_bn
from .layout import convert_to_nhwc
from .quantize_pass import QUANT_SUFFIX, SCALE_SUFFIX, quantize_inference

__all__ = ["quantize_inference", "QUANT_SUFFIX", "SCALE_SUFFIX",
           "convert_to_nhwc", "fuse_conv_bn"]
