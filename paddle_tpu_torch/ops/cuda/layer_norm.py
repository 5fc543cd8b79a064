"""Layer norm, forward (kernel #3) and backward (kernel #4), each beside
its plain PyTorch version.

``layer_norm_fwd`` launches ``csrc/layer_norm_fwd.cu`` (the Hopper port of
``paddle_tpu/ops/pallas/layer_norm.py:_fwd_kernel``) and
``layer_norm_bwd`` launches ``csrc/layer_norm_bwd.cu`` (the port of the
``_bwd`` kernel), both on CUDA tensors; ``layer_norm_reference`` and
``layer_norm_bwd_reference`` are the plain versions.  ``layer_norm`` is
what the op calls: one ``torch.autograd.Function`` whose forward and
backward launch the kernels for tensors on the card, run the plain
versions for tensors on the CPU, and raise for anything else.  The
forward returns (y in x's dtype, mean float32, variance float32) over the
rows of x [N, D]; the statistics are float32 whatever the input dtype and
are not differentiable.
"""

import ctypes

import torch

from . import build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_reference", "layer_norm_bwd_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1)
    xc = xf - mean[:, None]
    var = (xc * xc).mean(dim=-1)
    y = xc * torch.rsqrt(var[:, None] + eps) * gamma.float() + beta.float()
    return y.to(x.dtype), mean, var


def layer_norm_bwd_reference(x, gamma, mean, rstd, dy):
    """(dx, dgamma, dbeta) of ``layer_norm_reference`` from its float32
    mean and rstd = 1/sqrt(var + eps): with xhat = (x - mean) rstd and
    gg = dy gamma, dx = (gg - mean(gg) - xhat mean(gg xhat)) rstd, dgamma
    = sum over rows of dy xhat, dbeta = sum of dy.  Float32 inside; each
    gradient in its input's dtype."""
    xf, g = x.float(), dy.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    gg = g * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dx = (gg - m1 - xhat * m2) * rstd[:, None]
    return (dx.to(x.dtype), (g * xhat).sum(dim=0).to(gamma.dtype),
            g.sum(dim=0).to(gamma.dtype))


# kernel #3's entry point, bound once (a decode step calls it 12 times)
_fwd_fn = []


def _lib():
    if not _fwd_fn:
        fn = build.library("layer_norm_fwd").ptt_layer_norm_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
        _fwd_fn.append(fn)
    return _fwd_fn[0]


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """Launch kernel #3 on CUDA tensors x [N, D], gamma/beta [D].  The
    host path is kept short (at decode's [8, 512] it is most of a call):
    the entry point bound once, the current stream's raw handle."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("layer_norm_fwd runs on CUDA tensors, got %s" % dev)
    if x.dim() != 2:
        raise ValueError("layer_norm_fwd expects x [N, D], got %s"
                         % (tuple(x.shape),))
    n, d = x.shape
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError("layer_norm_fwd takes float32 or bfloat16 x, got %s"
                         % x.dtype)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (d,) or t.dtype != x.dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                "layer_norm_fwd: %s must be a contiguous [%d] %s tensor on "
                "%s, got %s %s on %s" % (name, d, x.dtype, dev,
                                         tuple(t.shape), t.dtype, t.device))
    if not x.is_contiguous():
        raise ValueError("layer_norm_fwd needs a contiguous x")
    y = torch.empty_like(x)
    mean = x.new_empty((n,), dtype=torch.float32)
    var = x.new_empty((n,), dtype=torch.float32)
    if n == 0 or d == 0:
        return y, mean, var
    err = _lib()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), var.data_ptr(), n, d,
                 float(eps), code, dev.index,
                 torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(err, "layer_norm_fwd x%s" % (tuple(x.shape),))
    layer_norm_fwd.launches += 1
    return y, mean, var


layer_norm_fwd.launches = 0


def _bwd_lib():
    lib = build.library("layer_norm_bwd")
    fn = lib.ptt_layer_norm_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i, i, i, i, i, i, p]
        fn.restype = i
        lib.ptt_layer_norm_bwd_resident.argtypes = [i, i, i, i]
        lib.ptt_layer_norm_bwd_resident.restype = i
    return fn


# warps a block of kernel #4's row pass; each takes every
# (_BWD_WARPS * blocks)-th row
_BWD_WARPS = 8
_BWD_MAX_D = 1024
# (device, dtype, D, vec) -> blocks of the row pass the card holds at once
_resident = {}


def _row_blocks(n, resident):
    """Grid of kernel #4's row pass: one wave of the card's resident
    blocks, fewer when the rows do not fill them (a warp a row)."""
    return max(1, min(-(-n // _BWD_WARPS), resident))


def layer_norm_bwd(x, gamma, mean, rstd, dy):
    """Launch kernel #4 on CUDA tensors x/dy [N, D], gamma [D], mean/rstd
    [N] float32; returns (dx, dgamma, dbeta).  dgamma and dbeta are
    reduced over rows in two passes through a [2, blocks, D] float32
    scratch, in a fixed order, so two runs give the same bits."""
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError("layer_norm_bwd expects a float32 or bfloat16 x "
                         "[N, D], got %s %s" % (tuple(x.shape), x.dtype))
    n, d = x.shape
    if d > _BWD_MAX_D:
        raise ValueError("layer_norm_bwd: row width %d of x %s is above "
                         "%d" % (d, tuple(x.shape), _BWD_MAX_D))
    for name, t, shape, dtype in (
            ("dy", dy, (n, d), x.dtype), ("gamma", gamma, (d,), x.dtype),
            ("mean", mean, (n,), torch.float32),
            ("rstd", rstd, (n,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                "layer_norm_bwd: %s must be a contiguous %s %s tensor on "
                "%s, got %s %s on %s" % (name, shape, dtype, x.device,
                                         tuple(t.shape), t.dtype, t.device))
    if not x.is_contiguous():
        raise ValueError("layer_norm_bwd needs a contiguous x")
    if x.device.type != "cuda":
        raise ValueError("layer_norm_bwd runs on CUDA tensors, got %s"
                         % x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    if n == 0 or d == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    fn = _bwd_lib()
    code = _DTYPE_CODE[x.dtype]
    # 16-byte row vectors where every row starts on 16 bytes
    vec = int(d * x.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, dy, dx)))
    key = (x.device.index, code, d, vec)
    if key not in _resident:
        res = build.library("layer_norm_bwd").ptt_layer_norm_bwd_resident(
            d, vec, code, x.device.index)
        build.check(-res if res < 0 else 0,
                    "layer_norm_bwd x%s" % (tuple(x.shape),))
        _resident[key] = res
    blocks = _row_blocks(n, _resident[key])
    part = torch.empty((2, blocks, d), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             dgamma.data_ptr(), dbeta.data_ptr(), part.data_ptr(), n, d,
             blocks, vec, code, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layer_norm_bwd x%s" % (tuple(x.shape),))
    layer_norm_bwd.launches += 1
    return dx, dgamma, dbeta


layer_norm_bwd.launches = 0


def _forward(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    return layer_norm_fwd(x, gamma, beta, eps)


class _LayerNorm(torch.autograd.Function):
    """Kernel #3 forward, kernel #4 backward (the plain versions for CPU
    tensors); the JAX package's ``custom_vjp`` pair.  Mean and variance
    are outputs without gradients."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, var = _forward(x, gamma, beta, eps)
        ctx.mark_non_differentiable(mean, var)
        ctx.save_for_backward(x, gamma, mean, torch.rsqrt(var + eps))
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, rstd = ctx.saved_tensors
        args = (x, gamma, mean, rstd, dy.contiguous())
        if x.device.type == "cpu":
            dx, dgamma, dbeta = layer_norm_bwd_reference(*args)
        else:
            dx, dgamma, dbeta = layer_norm_bwd(*args)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """The op's entry, differentiable in x, gamma and beta: kernels #3/#4
    for CUDA tensors, the plain versions for CPU tensors.  Without a
    gradient to record (serving) it skips the autograd Function and its
    host-side bookkeeping."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return _forward(x, gamma, beta, eps)
