"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (kernels #1 forward and #2 backward),
``layer_norm`` (#3 and #4), ``softmax_xent`` (#5 and #6),
``quant_matmul`` (#7) and ``conv_bn`` (#8-#11), numbered as the TPU kernel
table in PERF.md.  ``build`` compiles ``paddle_tpu_torch/csrc`` with nvcc
at first use."""

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
