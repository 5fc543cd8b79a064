"""Program rewrites (counterpart of ``paddle_tpu/transpiler``): the int8
inference pass ``quantize_inference``, the whole-trunk NHWC layout pass
``convert_to_nhwc``, the conv+BN fusion pass ``fuse_conv_bn``, the BN
folding ``InferenceTranspiler``, ``memory_optimize`` / ``release_memory``,
the pass registry (``passes``) and ``nan_debug``, the op-by-op replay
of NaN provenance, and the mesh runtime's sharding planner
``DistributeTranspiler`` with its dispatchers."""

from . import nan_debug  # noqa: F401

from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)

from .fusion import fuse_conv_bn
from .inference_transpiler import InferenceTranspiler
from .layout import convert_to_nhwc
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, PSDispatcher, RoundRobin
from .passes import (PassBuilder, apply_pass, const_fold, dead_var_eliminate,
                     find_chain, get_pass, list_passes, register_pass)
from .quantize_pass import QUANT_SUFFIX, SCALE_SUFFIX, quantize_inference

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "PSDispatcher", "RoundRobin", "HashName", "memory_optimize", "release_memory", "InferenceTranspiler",
           "fuse_conv_bn", "convert_to_nhwc", "apply_pass", "register_pass",
           "get_pass", "list_passes", "PassBuilder", "find_chain",
           "dead_var_eliminate", "const_fold", "quantize_inference",
           "QUANT_SUFFIX", "SCALE_SUFFIX"]
