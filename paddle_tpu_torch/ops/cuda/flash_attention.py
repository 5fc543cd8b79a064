"""Flash attention, forward (kernel #1) and backward (kernel #2), each
beside its plain PyTorch version.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` (the
Hopper port of ``paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel``)
and ``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu`` (the
port of ``_dq_kernel`` and ``_dkv_kernel``), both on CUDA tensors;
``reference_attention`` (with ``reference_attention_lse``) and
``attention_bwd_reference`` are the plain versions of the same functions
(the explicit formulas, including the ``_keep_mask`` dropout hash).
``flash_attention`` is what the op calls: one ``torch.autograd.Function``
whose forward and backward launch the kernels for tensors on the card and
run the plain versions for tensors on the CPU, and raise for anything
else — there is no fallback from a kernel to its plain version.

Masks: ``k_len`` [B] valid keys per batch row (clamped to Tk; None = all);
``causal`` is top-aligned when Tq == Tk and suffix-aligned when Tq < Tk
(query i sits at key position klen - Tq + i: the KV-cache decode shape).
Dropout is ``downgrade_in_infer``'s training half: weights masked by the
counter hash, not upscaled.  The hash's seed is device data: a one-element
int32 tensor holding the uint32 (``seed_tensor``; the executor derives one
per op and run with ``hash32.op_seeds``), which the kernels read from
device memory, so a replayed CUDA graph draws the run's own mask.  Fully
masked rows come back as zeros.

``rows`` = (b0, h0, hg) says which rows of a larger tensor the call's
tensors are (a shard of the mesh runtime, ``parallel``): their batch rows
start at b0 and their heads at h0 of hg, and (b, h) hashes as the global
row (b0 + b) * hg + h0 + h, so each shard draws its slice of the global
mask.  None (b0 = h0 = 0, hg = H) is the whole tensor.
"""

import ctypes

import torch

from ...hash32 import M32, as_int32, mix32, mul32
from . import build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "library_attention", "reference_attention",
           "reference_attention_lse",
           "attention_bwd_reference", "keep_mask", "seed_tensor",
           "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30
_POS_BIG = 1e30
SUPPORTED_HEAD_DIMS = (64,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def seed_tensor(seed, device):
    """The uint32 ``seed`` as the kernels read it: one int32 element on
    ``device`` holding its bits."""
    return as_int32(torch.tensor([int(seed) & M32], device=device))


def keep_mask(seed, bh, gq, gk, rate):
    """Deterministic dropout keep-mask for global positions gq x gk of head
    row ``bh`` (broadcastable int tensors); True = keep.  ``seed`` is a
    uint32 as an int or as a one-element tensor (``seed_tensor``).
    Bit-identical to the JAX package's ``_keep_mask`` and to the kernel's
    ``keep``."""
    seed = (seed.reshape(()).long() if isinstance(seed, torch.Tensor)
            else int(seed)) & M32
    h = mul32(gq.long(), 0x85EBCA6B) ^ mul32(gk.long(), 0xC2B2AE35)
    h = h ^ ((seed + mul32(bh.long(), 0x9E3779B1)) & M32)
    h = mix32(h)
    return (h >> 8) >= int(rate * float(1 << 24))


def _causal_valid(gq, gk, klen, tq, tk):
    if tq == tk:
        return gq >= gk
    return gq + (klen - tq) >= gk


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def hash_rows(rows, h):
    """``rows`` as (b0, h0, hg): the whole tensor's (0, 0, ``h``) for
    None."""
    if rows is None:
        return 0, 0, int(h)
    b0, h0, hg = (int(r) for r in rows)
    if b0 < 0 or h0 < 0 or h0 + h > hg:
        raise ValueError("dropout hash rows %r do not hold %d heads"
                         % (tuple(rows), h))
    return b0, h0, hg


def _masks(q, k, k_len, seed, causal, dropout_rate, rows=None):
    """(valid [B,1|H,Tq,Tk], keep or None): the key-length and causal
    masks, and the dropout keep-mask of every (b*h, query, key), hashed
    at the global rows ``rows`` say."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    dev = q.device
    gq = torch.arange(tq, device=dev)[:, None]
    gk = torch.arange(tk, device=dev)[None, :]
    klen = (torch.full((b,), tk, device=dev) if k_len is None
            else k_len.to(device=dev, dtype=torch.int64).reshape(b)
            .clamp(max=tk)).reshape(b, 1, 1, 1)
    valid = gk < klen
    if causal:
        valid = valid & _causal_valid(gq, gk, klen, tq, tk)
    keep = None
    if dropout_rate:
        b0, h0, hg = hash_rows(rows, h)
        bh = ((torch.arange(b, device=dev) + b0)[:, None] * hg
              + torch.arange(h, device=dev) + h0).reshape(b, h, 1, 1)
        keep = keep_mask(0 if seed is None else seed, bh, gq, gk,
                         dropout_rate)
    return valid, keep


def _scaled_q(q, scale):
    # scale * Q rounded to q's dtype, as the kernels and the JAX package
    # round the product operand
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return (q * torch.tensor(scale, dtype=q.dtype)).float(), scale


def reference_attention_lse(q, k, v, k_len=None, seed=None, causal=False,
                            dropout_rate=0.0, scale=None, rows=None):
    """Attention over q [B,H,Tq,D], k/v [B,H,Tk,D] with the kernel's masks
    and dropout; materializes the [B,H,Tq,Tk] scores.  Products take
    operands in the input dtype and sum in float32.  Returns (O in q's
    dtype, LSE [B,H,Tq] float32 with +1e30 on fully masked rows)."""
    qs, _ = _scaled_q(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    valid, keep = _masks(q, k, k_len, seed, causal, dropout_rate, rows)
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    y = p / l.clamp_min(1e-37)
    if keep is not None:
        y = torch.where(keep, y, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", y.to(q.dtype).float(),
                       v.float()).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)), _POS_BIG)
    return out, lse[..., 0]


def reference_attention(q, k, v, k_len=None, seed=None, causal=False,
                        dropout_rate=0.0, scale=None, rows=None):
    """``reference_attention_lse`` without the LSE: O in q's dtype."""
    return reference_attention_lse(q, k, v, k_len, seed, causal,
                                   dropout_rate, scale, rows)[0]


def library_attention(q, k, v, k_len=None, causal=False, scale=None):
    """The library arm of kernel #1 (a tuner's ``false`` ruling,
    ``autotune.attention_choice``): one ``F.scaled_dot_product_attention``
    call with the key-length and causal masks as its boolean
    ``attn_mask``, and the rows with no valid key set to zeros, as the
    kernel returns them.  There is no dropout arm: the kernel's
    ``keep_mask`` hash has no library counterpart."""
    valid, _ = _masks(q, k, k_len, None, causal, 0.0)
    d = q.shape[-1]
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=valid,
        scale=scale if scale is not None else 1.0 / (d ** 0.5))
    return torch.where(valid.any(dim=-1, keepdim=True), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def attention_bwd_reference(q, k, v, k_len, seed, causal, dropout_rate,
                            scale, out, lse, dout, rows=None):
    """dQ, dK, dV of ``reference_attention`` from its saved O and LSE, by
    the explicit formulas of the JAX kernels: P = exp(S - LSE) under the
    masks (zero on fully masked rows, whose LSE is +1e30), G = dO V^T with
    dropped weights zeroed, delta = rowsum(dO * O), dS = P (G - delta);
    dV = P_drop^T dO, dK = dS^T (scale Q), dQ = scale dS K.  The operands
    of each product are rounded to q's dtype, as the kernels round them;
    returns each gradient in its input's dtype."""
    dt = q.dtype
    qs, scale = _scaled_q(q, scale)
    valid, keep = _masks(q, k, k_len, seed, causal, dropout_rate, rows)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    s = torch.where(valid, s, _NEG_INF)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]), 0.0)
    g = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    p_drop = p
    if keep is not None:
        g = torch.where(keep, g, 0.0)
        p_drop = torch.where(keep, p, 0.0)
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (g - delta)).to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop.to(dt).float(), dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs.to(dt).float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib():
    lib = build.library("flash_attention_fwd")
    fn = lib.ptt_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i,
                       p, ctypes.c_uint, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


# A mirror of kernel #1's key split for the CPU tests and chip_smoke's
# cross-check; the wrapper never consults it (the kernel plans its own
# launch).  A (b*h, 64-query tile) spreads its keys over a cluster of up to
# 8 blocks while the grid stays within a wave of resident blocks (4 an SM
# of 132) and each rank keeps a 64-key tile: decode steps and small
# prefills alike.
_FWD_TILE, _MAX_CLUSTER, _WAVE = 64, 8, 4 * 132


def _split_cluster(b, h, tq, tk):
    """The cluster size kernel #1 launches a shape with (1: no split); the
    kernel's ``cluster_size``, for tests."""
    blocks, c = b * h * -(-tq // _FWD_TILE), 1
    while c < _MAX_CLUSTER and blocks * c * 2 <= _WAVE \
            and c * 2 * _FWD_TILE <= tk:
        c *= 2
    return c


def _key_slices(kend, cluster):
    """The key ranges [start, end) of the cluster's ranks, in rank order,
    over the keys [0, kend) a query tile can see: whole 64-key tiles a
    rank, empty past ``kend``; the kernel's ``key_slice``, for tests."""
    n = max(kend, 0)
    per_rank = -(-n // cluster)
    chunk = -(-per_rank // _FWD_TILE) * _FWD_TILE
    starts = [min(r * chunk, n) for r in range(cluster)]
    return [(s, min(s + chunk, n)) for s in starts]


def _seed_ptr(seed, q, dropout_rate, who):
    """The device address of the dropout seed (None without dropout): a
    one-element int32 tensor on q's device, which the kernel reads."""
    if not dropout_rate:
        return None
    if not isinstance(seed, torch.Tensor) or seed.numel() != 1 \
            or seed.dtype != torch.int32 or seed.device != q.device:
        raise ValueError(
            "%s: with dropout the seed is a one-element int32 tensor on %s "
            "(seed_tensor), got %r" % (who, q.device, seed))
    return seed.data_ptr()


def flash_attention_fwd(q, k, v, k_len=None, seed=None, causal=False,
                        dropout_rate=0.0, scale=None, rows=None):
    """Launch kernel #1 on CUDA tensors; returns (O [B,H,Tq,D] in q's
    dtype, LSE [B,H,Tq] float32).  One device kernel a call (a decode
    shape's key split included).  Raises on what the kernel does not
    take."""
    # shapes and types first, so that the messages name them on any device
    # (the head dim, which only the card's kernel limits, after the device)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd expects [B,H,T,D] q/k/v, got "
                         "%s/%s/%s" % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    b0, h0, hg = hash_rows(rows, h)
    if tuple(k.shape) != (b, h, tk, d) or tuple(v.shape) != (b, h, tk, d):
        raise ValueError("flash_attention_fwd: k/v must be [%d,%d,Tk,%d], "
                         "got %s/%s" % (b, h, d, tuple(k.shape),
                                        tuple(v.shape)))
    if causal and tq > tk:
        raise ValueError("flash_attention_fwd: causal needs Tq <= Tk, got "
                         "q %s, k %s" % (tuple(q.shape), tuple(k.shape)))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd takes float32 or bfloat16 "
                         "q/k/v of one dtype, got %s/%s/%s"
                         % (q.dtype, k.dtype, v.dtype))
    if k_len is not None and k_len.numel() != b:
        raise ValueError("flash_attention_fwd: k_len has %d entries for "
                         "batch %d" % (k_len.numel(), b))
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd runs on CUDA tensors, got %s"
                         % q.device)
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError("flash_attention_fwd: head dim %d of q %s is not "
                         "one of %s" % (d, tuple(q.shape),
                                        SUPPORTED_HEAD_DIMS))
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q/k/v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous q/k/v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd needs 16-byte aligned q/k/v, "
                         "got q %s k %s" % (tuple(q.shape), tuple(k.shape)))
    # the kernel clamps k_len to Tk itself: no launch here for an int32 k_len
    klen = (None if k_len is None else
            k_len.to(device=q.device, dtype=torch.int32).reshape(b)
            .contiguous())
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    thresh = int(dropout_rate * float(1 << 24)) if dropout_rate else 0
    seed_ptr = _seed_ptr(seed, q, dropout_rate, "flash_attention_fwd")
    fn = _lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if klen is None else klen.data_ptr(),
             out.data_ptr(), lse.data_ptr(), b, h, tq, tk, d, scale,
             int(bool(causal)), seed_ptr,
             thresh, int(bool(dropout_rate)), b0, h0, hg, _DTYPE_CODE[q.dtype],
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd q%s k%s" % (tuple(q.shape),
                                                      tuple(k.shape)))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _bwd_lib():
    fn = build.library("flash_attention_bwd").ptt_flash_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i, i, i, i, i, ctypes.c_float, i,
                                  p, ctypes.c_uint, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


# queries or keys a tile of kernel #2
_BWD_TILE = 64


def _dq_partials(b, h, tq, tk):
    """Shape of kernel #2's float32 dQ scratch: one [Tq, D] part per
    (b*h, 64-key tile), which a fixed-order pass adds up; None when one
    key tile covers Tk and the kernel writes dQ directly."""
    nkt = -(-tk // _BWD_TILE)
    if nkt <= 1:
        return None
    return (b * h, nkt, tq, SUPPORTED_HEAD_DIMS[0])


def flash_attention_bwd(q, k, v, k_len, seed, causal, dropout_rate, scale,
                        out, lse, dout, rows=None):
    """Launch kernel #2 on CUDA tensors: (dQ, dK, dV) of
    ``flash_attention_fwd`` from its O and LSE and the cotangent dO
    [B,H,Tq,D].  The kernel computes delta = rowsum(dO * O) and clamps
    ``k_len`` to Tk itself, so nothing else is launched when Tk <= 64;
    beyond that a fixed-order pass adds up the key tiles' dQ parts."""
    # shapes and types first, so that the messages name them on any device
    if q.dim() != 4:
        raise ValueError("flash_attention_bwd expects q [B,H,Tq,D], got %s"
                         % (tuple(q.shape),))
    b, h, tq, d = q.shape
    tk = k.shape[2] if k.dim() == 4 else -1
    b0, h0, hg = hash_rows(rows, h)
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (b, h, tq)),
                           ("k", k, (b, h, tk, d)), ("v", v, (b, h, tk, d))):
        if tuple(t.shape) != tuple(shape) or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(
                "flash_attention_bwd: %s must be a contiguous %s tensor on "
                "%s, got %s on %s" % (name, tuple(shape), q.device,
                                      tuple(t.shape), t.device))
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError("flash_attention_bwd: head dim %d of q %s is not "
                         "one of %s" % (d, tuple(q.shape),
                                        SUPPORTED_HEAD_DIMS))
    if q.dtype not in _DTYPE_CODE or any(
            t.dtype != q.dtype for t in (k, v, out, dout)) \
            or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd takes float32 or bfloat16 "
                         "q/k/v/out/dout of one dtype and a float32 lse, "
                         "got %s/%s/%s/%s/%s and %s" % (
                             q.dtype, k.dtype, v.dtype, out.dtype,
                             dout.dtype, lse.dtype))
    if causal and tq > tk:
        raise ValueError("flash_attention_bwd: causal needs Tq <= Tk, got "
                         "q %s, k %s" % (tuple(q.shape), tuple(k.shape)))
    if k_len is not None and k_len.numel() != b:
        raise ValueError("flash_attention_bwd: k_len has %d entries for "
                         "q %s" % (k_len.numel(), tuple(q.shape)))
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd runs on CUDA tensors, got %s"
                         % q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd needs 16-byte aligned "
                         "q/k/v/out/dout, got q %s k %s"
                         % (tuple(q.shape), tuple(k.shape)))
    klen = (None if k_len is None else
            k_len.to(device=q.device, dtype=torch.int32).reshape(b)
            .contiguous())
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    shape = _dq_partials(b, h, tq, tk)
    part = (None if shape is None else
            torch.empty(shape, dtype=torch.float32, device=q.device))
    thresh = int(dropout_rate * float(1 << 24)) if dropout_rate else 0
    seed_ptr = _seed_ptr(seed, q, dropout_rate, "flash_attention_bwd")
    err = _bwd_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if klen is None else klen.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, h, tq, tk, d, scale,
        int(bool(causal)), seed_ptr,
        thresh, int(bool(dropout_rate)), b0, h0, hg, _DTYPE_CODE[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd q%s k%s" % (tuple(q.shape),
                                                      tuple(k.shape)))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _forward(q, k, v, k_len, seed, causal, dropout_rate, scale, rows):
    if q.device.type == "cpu":
        return reference_attention_lse(q, k, v, k_len, seed, causal,
                                       dropout_rate, scale, rows)
    return flash_attention_fwd(q, k, v, k_len, seed, causal, dropout_rate,
                               scale, rows)


class _FlashAttention(torch.autograd.Function):
    """Kernel #1 forward, kernel #2 backward (the plain versions for CPU
    tensors); the JAX package's ``custom_vjp`` pair."""

    @staticmethod
    def forward(ctx, q, k, v, k_len, seed, causal, dropout_rate, scale, rows):
        out, lse = _forward(q, k, v, k_len, seed, causal, dropout_rate,
                            scale, rows)
        ctx.save_for_backward(q, k, v, k_len, out, lse)
        ctx.attrs = (seed, causal, dropout_rate, scale, rows)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, k_len, out, lse = ctx.saved_tensors
        seed, causal, rate, scale, rows = ctx.attrs
        args = (q, k, v, k_len, seed, causal, rate, scale, out, lse,
                dout.contiguous(), rows)
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_reference(*args)
        else:
            dq, dk, dv = flash_attention_bwd(*args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, k_len=None, seed=None, causal=False,
                    dropout_rate=0.0, scale=None, rows=None):
    """The op's entry, differentiable: kernels #1/#2 for CUDA tensors, the
    plain versions for CPU tensors.  Returns O in q's dtype.  Without a
    gradient to record (serving) it skips the autograd Function, whose
    bookkeeping costs more host time than the decode-shape kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, k_len, seed, causal,
                                     dropout_rate, scale, rows)
    return _forward(q, k, v, k_len, seed, causal, dropout_rate, scale,
                    rows)[0]
