"""Fused dequant-matmul (kernel #7) beside its plain PyTorch version.

``dequant_matmul_kernel`` launches ``csrc/quant_matmul.cu`` (the Hopper port
of ``paddle_tpu/ops/pallas/quant_matmul.py:dequant_matmul``) on CUDA tensors;
``dequant_matmul_reference`` is the plain version (the counterpart of
``paddle_tpu/ops/quantize.py:xla_dequant_matmul``).  ``dequant_matmul`` is
what the op calls: the kernel for tensors on the card, the plain version for
tensors on the CPU.  Unlike the JAX package, which sends small shapes and a
static ``XScale`` to XLA, the card takes every shape, both modes, float32,
bfloat16 and float16 activations, and the static activation scale.

x2 [M, K], qw [K, N] int8, scale [N] (``w ~= qw * scale``); the result is
the float32 [M, N].  ``weight_only`` widens the int8 weight into a float32
product; ``dynamic`` quantizes each row of x to an int8 grid (per-row
abs-max, or the trained ``xscale`` envelope), multiplies int8 by int8 into
int32 and rescales.
"""

import ctypes

import torch

from . import build

__all__ = ["dequant_matmul", "dequant_matmul_kernel",
           "dequant_matmul_reference", "quantize_rows_reference",
           "int8_matmul_reference", "quant_range", "MODES"]

MODES = ("weight_only", "dynamic")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quant_range(bit_length):
    """The largest grid value of a signed ``bit_length`` grid (127 for 8)."""
    return float((1 << (int(bit_length) - 1)) - 1)


def quantize_rows_reference(x2, xscale=None, bit_length=8):
    """The dynamic mode's activation grid: (qx int8 [M, K], sx float32).
    sx is [M, 1] (per-row abs-max) or a 0-d tensor (the static ``xscale``
    envelope).  ``torch.round`` rounds half to even, as ``jnp.round``.
    The divisor 127 is a tensor on x's device: PyTorch divides by a Python
    number on the card as a product with its reciprocal, which is not the
    IEEE quotient the JAX package (and the kernel) take."""
    rng = quant_range(bit_length)
    rng_t = torch.full((), rng, dtype=torch.float32, device=x2.device)
    xf = x2.float()
    if xscale is not None:
        amax = xscale.float().reshape(())
    else:
        amax = xf.abs().amax(dim=1, keepdim=True)
    sx = torch.clamp(amax, min=1e-12) / rng_t
    qx = torch.clamp(torch.round(xf / sx), -rng, rng).to(torch.int8)
    return qx, sx


def int8_matmul_reference(qx, qw):
    """The exact int32 product of two int8 matrices.  CUDA has no integer
    ``matmul``, so it is taken in float64: every product is at most 127^2
    and every sum at most 127^2 K < 2^53, so nothing rounds."""
    return (qx.double() @ qw.double()).to(torch.int32)


def dequant_matmul_reference(x2, qw, scale, mode="weight_only", xscale=None,
                             bit_length=8):
    """The plain version: the function of ``xla_dequant_matmul``."""
    scale = scale.float()
    if mode == "weight_only":
        return (x2.float() @ qw.float()) * scale
    if mode != "dynamic":
        raise ValueError("unknown dequant_matmul mode %r" % mode)
    qx, sx = quantize_rows_reference(x2, xscale, bit_length)
    return int8_matmul_reference(qx, qw).float() * sx * scale


def _fn(name, argtypes):
    fn = getattr(build.library("quant_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _splits(m, n, k):
    """The kernel an [m, k] x [k, n] product takes, as the library plans
    it: 0 for the prefill kernel, else the decode kernel's cluster size."""
    return _fn("ptt_dequant_matmul_splits", [_I] * 4)(m, n, k, 0)


# A mirror of the kernel's ``plan_of`` for the CPU tests and chip_smoke's
# cross-check; the wrapper never consults it (it asks ``_splits``).  The
# decode kernel: 128 columns a block, weight rows in stages of 64, 8, 16 or
# 32 rows of x, and a float32 x slice of at most 64 KB a block; K split
# over a cluster of up to 8 blocks while the column strips leave the card
# (about two blocks an SM of 132) short of blocks.
_BN, _WBK, _DECODE_M, _DECODE_X = 128, 64, 32, 65536
_MAX_CLUSTER, _DECODE_WAVE = 8, 2 * 132


def _k_splits(m, n, k):
    """(decode kernel?, splits, kchunk): the plan of ``plan_of``, for tests.
    The decode kernel (m <= 32) splits K over a cluster of ``splits``
    blocks, rank r taking rows [r kchunk, (r + 1) kchunk) of the weight
    (empty past k), and adds their partial sums in rank order inside the
    launch; the prefill kernel takes K whole."""
    if m > _DECODE_M:
        return False, 1, k
    strips = -(-n // _BN)
    bm = 8 if m <= 8 else 16 if m <= 16 else 32  # x rows a block

    def chunk(s):
        per_rank = -(-k // s)
        return max(_WBK, -(-per_rank // _WBK) * _WBK)
    s = 1
    while s < _MAX_CLUSTER and strips * s * 2 <= _DECODE_WAVE \
            and -(-k // (2 * s)) >= _WBK:
        s *= 2
    while s < _MAX_CLUSTER and chunk(s) * bm * 4 > _DECODE_X:
        s *= 2
    if chunk(s) * bm * 4 > _DECODE_X:
        return False, 1, k
    return True, s, chunk(s)


def _check(x2, qw, scale, mode, xscale, bit_length):
    # shapes and types first, so that the messages name them on any device
    if mode not in MODES:
        raise ValueError("unknown dequant_matmul mode %r" % mode)
    if x2.dim() != 2 or x2.dtype not in _DTYPE_CODE:
        raise ValueError("dequant_matmul_kernel expects a float32, bfloat16 "
                         "or float16 x [M, K], got %s %s"
                         % (tuple(x2.shape), x2.dtype))
    m, k = x2.shape
    if qw.dim() != 2 or qw.shape[0] != k or qw.dtype != torch.int8:
        raise ValueError("dequant_matmul_kernel: qw must be int8 [%d, N], got "
                         "%s %s" % (k, tuple(qw.shape), qw.dtype))
    n = qw.shape[1]
    if tuple(scale.shape) != (n,):
        raise ValueError("dequant_matmul_kernel: scale must be [%d], got %s"
                         % (n, tuple(scale.shape)))
    if xscale is not None and (mode != "dynamic" or xscale.numel() != 1):
        raise ValueError("dequant_matmul_kernel: xscale is one value of the "
                         "dynamic mode, got %s in %s mode"
                         % (tuple(xscale.shape), mode))
    if not 2 <= int(bit_length) <= 8:
        raise ValueError("dequant_matmul_kernel: bit_length %s is outside "
                         "the int8 grid" % bit_length)
    if x2.device.type != "cuda":
        raise ValueError("dequant_matmul_kernel runs on CUDA tensors, got %s"
                         % x2.device)
    for name, t in (("qw", qw), ("scale", scale), ("xscale", xscale)):
        if t is not None and t.device != x2.device:
            raise ValueError("dequant_matmul_kernel: %s is on %s, x on %s"
                             % (name, t.device, x2.device))
    if not (x2.is_contiguous() and qw.is_contiguous()):
        raise ValueError("dequant_matmul_kernel needs contiguous x and qw")
    return m, k, n


def dequant_matmul_kernel(x2, qw, scale, mode="weight_only", xscale=None,
                          bit_length=8, parts=False):
    """Launch kernel #7 on CUDA tensors; returns the float32 [M, N].  With
    ``parts=True`` in dynamic mode, returns (out, qx [M, K] int8, sx [M]
    float32, acc [M, N] int32) for checks against the plain version.  One
    device kernel a call, except the dynamic prefill (M > 32), which runs
    the row grid first."""
    m, k, n = _check(x2, qw, scale, mode, xscale, bit_length)
    dev = x2.device
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "weight_only":
        if m and n:
            if k:
                err = _fn("ptt_dequant_matmul_wo", [_P] * 5 + [_I] * 5 + [_P])(
                    x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), None, m, n, k, _DTYPE_CODE[x2.dtype],
                    dev.index, stream)
                build.check(err, "dequant_matmul_kernel x%s qw%s" % (
                    tuple(x2.shape), tuple(qw.shape)))
                dequant_matmul_kernel.launches += 1
            else:
                out.zero_()
        return out
    kp = (k + 3) // 4 * 4
    # the decode kernel keeps the row grid to itself unless asked for it
    grid = parts or (m and n and _splits(m, n, k) == 0)
    qx = torch.empty((m, kp), dtype=torch.int8, device=dev) if grid else None
    sx = torch.empty((m,), dtype=torch.float32, device=dev) if grid else None
    acc = (torch.empty((m, n), dtype=torch.int32, device=dev) if parts
           else None)
    if xscale is not None:
        xscale = xscale.to(torch.float32).reshape(1).contiguous()
    if m and n:
        err = _fn("ptt_dequant_matmul_dyn",
                  [_P] * 9 + [_I] * 4 + [ctypes.c_float, _I, _I, _P])(
            x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
            None if xscale is None else xscale.data_ptr(),
            None if qx is None else qx.data_ptr(),
            None if sx is None else sx.data_ptr(), out.data_ptr(),
            None if acc is None else acc.data_ptr(), None, m, n, k, kp,
            quant_range(bit_length), _DTYPE_CODE[x2.dtype], dev.index,
            stream)
        build.check(err, "dequant_matmul_kernel dynamic x%s qw%s" % (
            tuple(x2.shape), tuple(qw.shape)))
        dequant_matmul_kernel.launches += 1
    if parts:
        return out, qx[:, :k], sx, acc
    return out


dequant_matmul_kernel.launches = 0


def dequant_matmul(x2, qw, scale, mode="weight_only", xscale=None,
                   bit_length=8):
    """The op's entry: kernel #7 for CUDA tensors, the plain version for
    CPU tensors."""
    if x2.device.type == "cpu":
        return dequant_matmul_reference(x2, qw, scale, mode, xscale,
                                        bit_length)
    return dequant_matmul_kernel(x2, qw, scale, mode, xscale, bit_length)
