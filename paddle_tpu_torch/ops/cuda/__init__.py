"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (kernel B) and ``layer_norm`` (kernel A).
``build`` compiles ``paddle_tpu_torch/csrc`` with nvcc at first use."""

from . import build, flash_attention, layer_norm  # noqa: F401

# every kernel wrapper, by kernel name; each carries a ``launches`` count
KERNELS = {
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
    "layer_norm_fwd": layer_norm.layer_norm_fwd,
}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}
