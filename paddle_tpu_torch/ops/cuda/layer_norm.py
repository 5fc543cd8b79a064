"""Kernel A: layer-norm forward, and its plain PyTorch version.

``layer_norm_fwd`` launches ``csrc/layer_norm_fwd.cu`` (the Hopper port of
``paddle_tpu/ops/pallas/layer_norm.py:_fwd_kernel``) on CUDA tensors;
``layer_norm_reference`` is the plain version of the same function.
``layer_norm`` is what the op calls: the kernel for a tensor on the card,
the plain version for a tensor on the CPU, and an error for anything else.
All three return (y in x's dtype, mean float32, variance float32) over the
rows of x [N, D]; the statistics are float32 whatever the input dtype.
"""

import ctypes

import torch

from . import build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1)
    xc = xf - mean[:, None]
    var = (xc * xc).mean(dim=-1)
    y = xc * torch.rsqrt(var[:, None] + eps) * gamma.float() + beta.float()
    return y.to(x.dtype), mean, var


def _lib():
    fn = build.library("layer_norm_fwd").ptt_layer_norm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    return fn


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """Launch kernel A on CUDA tensors x [N, D], gamma/beta [D]."""
    if x.device.type != "cuda":
        raise ValueError("layer_norm_fwd runs on CUDA tensors, got %s"
                         % x.device)
    if x.dim() != 2:
        raise ValueError("layer_norm_fwd expects x [N, D], got %s"
                         % (tuple(x.shape),))
    n, d = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("layer_norm_fwd takes float32 or bfloat16 x, got %s"
                         % x.dtype)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (d,) or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                "layer_norm_fwd: %s must be a contiguous [%d] %s tensor on "
                "%s, got %s %s on %s" % (name, d, x.dtype, x.device,
                                         tuple(t.shape), t.dtype, t.device))
    if not x.is_contiguous():
        raise ValueError("layer_norm_fwd needs a contiguous x")
    y = torch.empty_like(x)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    var = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return y, mean, var
    err = _lib()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), var.data_ptr(), n, d,
                 float(eps), _DTYPE_CODE[x.dtype], x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layer_norm_fwd x%s" % (tuple(x.shape),))
    layer_norm_fwd.launches += 1
    return y, mean, var


layer_norm_fwd.launches = 0


def layer_norm(x, gamma, beta, eps=1e-5):
    """The op's entry: kernel A for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    return layer_norm_fwd(x, gamma, beta, eps)
