"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (kernels #1 forward and #2 backward),
``layer_norm`` (#3 and #4), ``softmax_xent`` (#5 and #6),
``quant_matmul`` (#7) and ``conv_bn`` (#8-#11), numbered as the TPU kernel
table in PERF.md.  ``build`` compiles ``paddle_tpu_torch/csrc`` with nvcc
at first use."""

import collections
import re

from . import (build, conv_bn, flash_attention,  # noqa: F401
               layer_norm, quant_matmul, softmax_xent)

# every kernel wrapper, by kernel name; each carries a ``launches`` count
KERNELS = {
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
    "flash_attention_bwd": flash_attention.flash_attention_bwd,
    "layer_norm_fwd": layer_norm.layer_norm_fwd,
    "layer_norm_bwd": layer_norm.layer_norm_bwd,
    "softmax_xent_fwd": softmax_xent.softmax_xent_fwd,
    "softmax_xent_bwd": softmax_xent.softmax_xent_bwd,
    "dequant_matmul": quant_matmul.dequant_matmul_kernel,
    "conv_bn_fwd": conv_bn.conv_bn_fwd,
    "conv_bn_bwd": conv_bn.conv_bn_bwd,
    "conv_bn_fwd_nhwc": conv_bn.conv_bn_fwd_nhwc,
    "conv_bn_bwd_nhwc": conv_bn.conv_bn_bwd_nhwc,
}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


# the device kernel that each wrapper runs exactly once a call, as a
# device trace (``torch.profiler``) names it; the wrapper's other kernels
# (a weight split, a reduction of partial sums) run beside it.  A CUDA
# graph's replay runs the kernels without their wrappers, so a trace is
# what counts a replayed step's launches.
DEVICE_KERNELS = {
    "flash_attention_fwd": r"flash_(fwd|decode)_kernel<",
    "flash_attention_bwd": r"flash_bwd_kernel<",
    "layer_norm_fwd": r"layer_norm_fwd_kernel<",
    "layer_norm_bwd": r"layer_norm_bwd_rows<",
    "softmax_xent_fwd": r"softmax_xent_fwd_kernel<",
    "softmax_xent_bwd": r"softmax_xent_bwd_kernel<",
    "dequant_matmul": r"(gemv|gemm)_kernel<",
    # conv_bn.cu's kernels take an Act, conv_bn_nhwc.cu's a Src
    "conv_bn_fwd": r"fwd_kernel<.*\(anonymous namespace\)::Act\b",
    "conv_bn_bwd": r"dx_kernel<.*\(anonymous namespace\)::Act\b",
    "conv_bn_fwd_nhwc": r"fwd_kernel<.*\(anonymous namespace\)::Src\b",
    "conv_bn_bwd_nhwc": r"dx_kernel<.*\(anonymous namespace\)::Src\b",
}
# every kernel of the port sits in a top-level anonymous namespace
_DEVICE_NAME = {k: re.compile(r"void \(anonymous namespace\)::" + p)
                for k, p in DEVICE_KERNELS.items()}


def device_launch_counts(names):
    """{kernel: launches} from the names of the device kernels a trace
    recorded, one name a launch."""
    counts = dict.fromkeys(KERNELS, 0)
    # a trace repeats few names: each is matched once
    for name, n in collections.Counter(names).items():
        for kernel, pattern in _DEVICE_NAME.items():
            if pattern.match(name):
                counts[kernel] += n
    return counts
