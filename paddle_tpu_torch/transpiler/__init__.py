"""Program rewrites (counterpart of ``paddle_tpu/transpiler``): the int8
inference pass ``quantize_inference``, the whole-trunk NHWC layout pass
``convert_to_nhwc``, the conv+BN fusion pass ``fuse_conv_bn``, the BN
folding ``InferenceTranspiler``, ``memory_optimize`` / ``release_memory``,
and the pass registry (``passes``).  The distributed transpiler, its
dispatchers and ``nan_debug`` are not ported yet (ROADMAP A6, A7)."""

from .fusion import fuse_conv_bn
from .inference_transpiler import InferenceTranspiler
from .layout import convert_to_nhwc
from .memory_optimization_transpiler import memory_optimize, release_memory
from .passes import (PassBuilder, apply_pass, const_fold, dead_var_eliminate,
                     find_chain, get_pass, list_passes, register_pass)
from .quantize_pass import QUANT_SUFFIX, SCALE_SUFFIX, quantize_inference

__all__ = ["memory_optimize", "release_memory", "InferenceTranspiler",
           "fuse_conv_bn", "convert_to_nhwc", "apply_pass", "register_pass",
           "get_pass", "list_passes", "PassBuilder", "find_chain",
           "dead_var_eliminate", "const_fold", "quantize_inference",
           "QUANT_SUFFIX", "SCALE_SUFFIX"]
