"""Kernel B: flash-attention forward, and its plain PyTorch version.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` (the
Hopper port of ``paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel``)
on CUDA tensors; ``reference_attention`` is the plain version of the same
function (a port of the JAX package's ``reference_attention``, including
the ``_keep_mask`` dropout hash).  ``flash_attention`` is what the op
calls: the kernel for a tensor on the card, the plain version for a
tensor on the CPU, and an error for anything else — there is no fallback
from the kernel to the plain version.

Masks: ``k_len`` [B] valid keys per batch row (clamped to Tk; None = all);
``causal`` is top-aligned when Tq == Tk and suffix-aligned when Tq < Tk
(query i sits at key position klen - Tq + i: the KV-cache decode shape).
Dropout is ``downgrade_in_infer``'s training half: weights masked by the
counter hash, not upscaled.  Fully masked rows come back as zeros.
"""

import ctypes

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_fwd", "reference_attention",
           "keep_mask", "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
SUPPORTED_HEAD_DIMS = (64,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the dropout hash, in int64 arithmetic masked to 32 bits
# ---------------------------------------------------------------------------

def _mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor ``a`` in [0, 2**32) and a
    constant ``c`` < 2**32, without int64 overflow: split c in 16-bit
    halves so every partial product stays below 2**48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h):
    """murmur3 finalizer on values held as uint32 in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def keep_mask(seed, bh, gq, gk, rate):
    """Deterministic dropout keep-mask for global positions gq x gk of head
    row ``bh`` (broadcastable int tensors); True = keep.  Bit-identical to
    the JAX package's ``_keep_mask`` and to the kernel's ``keep``."""
    h = _mul32(gq.long(), 0x85EBCA6B) ^ _mul32(gk.long(), 0xC2B2AE35)
    h = h ^ ((int(seed) + _mul32(bh.long(), 0x9E3779B1)) & _M32)
    h = _mix32(h)
    return (h >> 8) >= int(rate * float(1 << 24))


def _causal_valid(gq, gk, klen, tq, tk):
    if tq == tk:
        return gq >= gk
    return gq + (klen - tq) >= gk


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, k_len=None, seed=None, causal=False,
                        dropout_rate=0.0, scale=None):
    """Attention over q [B,H,Tq,D], k/v [B,H,Tk,D] with the kernel's masks
    and dropout; materializes the [B,H,Tq,Tk] scores.  Products take
    operands in the input dtype and sum in float32; returns q's dtype."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dev = q.device
    s = torch.einsum("bhqd,bhkd->bhqk",
                     (q * torch.tensor(scale, dtype=q.dtype)).float(),
                     k.float())
    gq = torch.arange(tq, device=dev)[:, None]
    gk = torch.arange(tk, device=dev)[None, :]
    klen = (torch.full((b,), tk, device=dev) if k_len is None
            else k_len.to(device=dev, dtype=torch.int64).reshape(b)
            .clamp(max=tk)).reshape(b, 1, 1, 1)
    valid = gk < klen
    if causal:
        valid = valid & _causal_valid(gq, gk, klen, tq, tk)
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    y = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    if dropout_rate:
        bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
        keep = keep_mask(0 if seed is None else seed, bh, gq, gk,
                         dropout_rate)
        y = torch.where(keep, y, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", y.to(q.dtype).float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib():
    lib = build.library("flash_attention_fwd")
    fn = lib.ptt_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i,
                       ctypes.c_uint, ctypes.c_uint, i, i, i, p]
        fn.restype = i
    return fn


def flash_attention_fwd(q, k, v, k_len=None, seed=None, causal=False,
                        dropout_rate=0.0, scale=None):
    """Launch kernel B on CUDA tensors; returns (O [B,H,Tq,D] in q's
    dtype, LSE [B,H,Tq] float32).  Raises on what the kernel does not
    take."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd runs on CUDA tensors, got %s"
                         % q.device)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd expects [B,H,T,D] q/k/v, got "
                         "%s/%s/%s" % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tuple(k.shape) != (b, h, tk, d) or tuple(v.shape) != (b, h, tk, d):
        raise ValueError("flash_attention_fwd: k/v must be [%d,%d,Tk,%d], "
                         "got %s/%s" % (b, h, d, tuple(k.shape),
                                        tuple(v.shape)))
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError("flash_attention_fwd: head dim %d of q %s is not "
                         "one of %s" % (d, tuple(q.shape),
                                        SUPPORTED_HEAD_DIMS))
    if causal and tq > tk:
        raise ValueError("flash_attention_fwd: causal needs Tq <= Tk, got "
                         "q %s, k %s" % (tuple(q.shape), tuple(k.shape)))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd takes float32 or bfloat16 "
                         "q/k/v of one dtype, got %s/%s/%s"
                         % (q.dtype, k.dtype, v.dtype))
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q/k/v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous q/k/v")
    if k_len is None:
        klen = torch.full((b,), tk, dtype=torch.int32, device=q.device)
    else:
        if k_len.numel() != b:
            raise ValueError("flash_attention_fwd: k_len has %d entries for "
                             "batch %d" % (k_len.numel(), b))
        klen = k_len.to(device=q.device, dtype=torch.int32).reshape(b) \
            .clamp(max=tk).contiguous()
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    thresh = int(dropout_rate * float(1 << 24)) if dropout_rate else 0
    fn = _lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), klen.data_ptr(),
             out.data_ptr(), lse.data_ptr(), b, h, tq, tk, d, scale,
             int(bool(causal)), (int(seed) if seed is not None else 0) & _M32,
             thresh, int(bool(dropout_rate)), _DTYPE_CODE[q.dtype],
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd q%s k%s" % (tuple(q.shape),
                                                      tuple(k.shape)))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, k_len=None, seed=None, causal=False,
                    dropout_rate=0.0, scale=None):
    """The op's entry: kernel B for CUDA tensors, the plain version for
    CPU tensors.  Returns O in q's dtype."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, k_len, seed, causal,
                                   dropout_rate, scale)
    return flash_attention_fwd(q, k, v, k_len, seed, causal, dropout_rate,
                               scale)[0]
