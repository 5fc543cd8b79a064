"""The fused BN-apply -> 1x1 conv -> batch-stats layer: kernels #8 (NCHW
forward), #9 (NCHW backward), #10 (NHWC forward) and #11 (NHWC backward),
each beside its plain PyTorch version.

``conv_bn_fwd`` and ``conv_bn_bwd`` launch ``csrc/conv_bn.cu``,
``conv_bn_fwd_nhwc`` and ``conv_bn_bwd_nhwc`` ``csrc/conv_bn_nhwc.cu``, all
on the tensor cores (``wgmma``, float32 as three TF32 passes, see
``matmul_tf32x3``): the Hopper ports of ``paddle_tpu/ops/pallas/conv_bn.py``'s
``_fwd_call``, ``_bwd_call``, ``_fwd_call_nhwc`` and ``_bwd_call_nhwc``, on
CUDA tensors; ``bn_act_matmul_reference`` and
``bn_act_matmul_bwd_reference`` are the
plain versions of both layouts.  ``forward`` and ``backward`` are what the
``bn_act_conv2d`` op and its grad op call: the kernels for tensors on the
card, the plain versions for tensors on the CPU.  ``bn_act_matmul`` and
``bn_act_matmul_nhwc`` wrap the pair in a ``torch.autograd.Function``, the
counterparts of the JAX package's ``custom_vjp``s of the same names.

Layouts: NCHW x is [B, C, HW] (a free reshape of [B, C, H, W]), z [B, O,
HW]; NHWC x is [M, C] (M = B*H*W), z [M, O].  W is [O, C] in both (the
1x1 filter); the kernels take it through its strides, so the JAX API's
[C, O] of the NHWC form is ``w.t()`` with nothing copied.  With the
producer's batch mean and rstd = 1 / sqrt(var + eps), and gamma/beta over
the C input channels:

    xn    = act(((x - mean) rstd) gamma + beta)   (apply_bn; else act(x))
    z     = W xn, with xn rounded to x's dtype and the sum in float32
    sum   = sum over positions of (z - shift),  sumsq of (z - shift)^2

``shift`` (float32 [O]) is the consumer BN's running mean: the stats are
accumulated shifted, as a guard against cancellation in the one-pass
variance.  The backward folds ``dsum + 2 (z - shift) dsumsq`` into dz when
``with_stats`` (the stats have a cotangent), recomputes xn, and returns dx
in x's dtype and dW [O, C], dgamma, dbeta [C] in float32.
"""

import ctypes

import torch

from . import build

__all__ = ["conv_bn_fwd", "conv_bn_bwd", "conv_bn_fwd_nhwc",
           "conv_bn_bwd_nhwc", "bn_act_matmul_reference",
           "bn_act_matmul_bwd_reference", "forward", "backward",
           "stats_grads", "bn_act_matmul", "bn_act_matmul_nhwc",
           "tf32_round", "matmul_tf32x3"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128          # the kernels' tile width (rows and columns)
# k tiles of 128 bytes: the NHWC dW chunks are multiples of it, and the
# NCHW kernels' W tiles (``_w_tiles``) are cut by it
_K_TILE = {torch.float32: 32, torch.bfloat16: 64}
# dW splits its contraction over positions into about two waves of one
# block an SM (132 SMs), in chunks of at least this many positions
_DW_BLOCKS, _DW_MIN_CHUNK = 264, 256


def _shapes(x, w, nhwc):
    """(N positions, HW, C, O, channel-vector view shape, position dims)."""
    o, c = w.shape
    if nhwc:
        return x.shape[0], 1, c, o, (1, -1), (0,)
    return x.shape[0] * x.shape[2], x.shape[2], c, o, (1, -1, 1), (0, 2)


def _act_norm(x, mean, rstd, gamma, beta, act, apply_bn, view):
    """act(norm(x)) in float32, as the kernels' prologue computes it."""
    xf = x.float()
    if apply_bn:
        xf = (xf - mean.view(view)) * rstd.view(view) * gamma.view(view) \
            + beta.view(view)
    return torch.relu(xf) if act == "relu" else xf


def bn_act_matmul_reference(x, w, mean, rstd, gamma, beta, shift, act="relu",
                            apply_bn=True, with_stats=True, nhwc=False):
    """(z in x's dtype, sum [O], sumsq [O]) of the fused layer; sum and
    sumsq are zeros without ``with_stats``."""
    _, _, _, o, view, pos = _shapes(x, w, nhwc)
    xn = _act_norm(x, mean, rstd, gamma, beta, act, apply_bn, view)
    xn = xn.to(x.dtype).float()
    wf = w.float()
    z = xn @ wf.t() if nhwc else torch.matmul(wf, xn)
    if with_stats:
        zc = z - shift.float().view(view)
        s, ss = zc.sum(dim=pos), (zc * zc).sum(dim=pos)
    else:
        s = ss = torch.zeros(o, dtype=torch.float32, device=x.device)
    return z.to(x.dtype), s, ss


def bn_act_matmul_bwd_reference(x, w, z, dz, dsum, dsumsq, mean, rstd, gamma,
                                beta, shift, act="relu", apply_bn=True,
                                with_stats=True, nhwc=False):
    """(dx in x's dtype, dW [O, C], dgamma [C], dbeta [C] float32) of the
    fused layer; dgamma and dbeta are zeros without ``apply_bn``."""
    _, _, c, _, view, pos = _shapes(x, w, nhwc)
    d = dz.float()
    if with_stats:
        d = d + dsum.float().view(view) \
            + 2.0 * (z.float() - shift.float().view(view)) \
            * dsumsq.float().view(view)
    d = d.to(x.dtype).float()
    xf = x.float()
    relu = act == "relu"
    if apply_bn:
        pre = (xf - mean.view(view)) * rstd.view(view)
        ylin = pre * gamma.view(view) + beta.view(view)
        xn = torch.relu(ylin) if relu else ylin
    else:
        xn = torch.relu(xf) if relu else xf
    xn = xn.to(x.dtype).float()
    wf = w.float()
    if nhwc:
        dw = d.t() @ xn
        dxn = d @ wf
    else:
        o = wf.shape[0]
        dw = d.transpose(0, 1).reshape(o, -1) \
            @ xn.transpose(0, 1).reshape(c, -1).t()
        dxn = torch.matmul(wf.t(), d)
    if apply_bn:
        dylin = dxn * (ylin > 0) if relu else dxn
        dgamma = (dylin * pre).sum(dim=pos)
        dbeta = dylin.sum(dim=pos)
        dx = dylin * (gamma * rstd).view(view)
    else:
        dx = dxn * (xf > 0) if relu else dxn
        dgamma = dbeta = torch.zeros(c, dtype=torch.float32, device=x.device)
    return dx.to(x.dtype), dw, dgamma, dbeta


def tf32_round(v):
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 mantissa bits, to nearest, ties away from zero (add 0x1000 to the
    magnitude's bits, clear the low 13)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32x3(a, b, passes=3):
    """``a @ b`` as kernels #8-#11 take a float32 product on the tensor
    cores: each operand split into hi = tf32(v) and lo = tf32(v - hi), and
    lo·hi + hi·lo + hi·hi summed in float32, small terms first.  With
    ``passes=1`` only hi·hi, one TF32 pass.  For the tests: it shows on the
    CPU what the three passes keep of a float32 product."""
    a, b = a.float(), b.float()
    ah, bh = tf32_round(a), tf32_round(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _fwd_lib(nhwc):
    if nhwc:
        fn = build.library("conv_bn_nhwc").ptt_conv_bn_nhwc_fwd
    else:
        fn = build.library("conv_bn").ptt_conv_bn_fwd
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, q, q] + [p] * (8 if nhwc else 9) + [q] \
            + [i] * (7 if nhwc else 8) + [p]
        fn.restype = i
    return fn


def _bwd_lib(nhwc):
    if nhwc:
        fn = build.library("conv_bn_nhwc").ptt_conv_bn_nhwc_bwd
    else:
        fn = build.library("conv_bn").ptt_conv_bn_bwd
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, q, q] + [p] * (14 if nhwc else 15) + [q] \
            + [i] * (6 if nhwc else 7) + [q, i, i, p]
        fn.restype = i
    return fn


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check(name, x, w, nhwc, vectors, acts):
    """Raise on what the kernels do not take: x and the activations in
    ``acts`` contiguous CUDA tensors of one float32/bfloat16 dtype and the
    layout's shape, w [O, C] of that dtype, and ``vectors`` (name, tensor,
    length) float32 contiguous [length] (None skipped)."""
    if x.device.type != "cuda":
        raise ValueError("%s runs on CUDA tensors, got %s" % (name, x.device))
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("%s takes float32 or bfloat16 x, got %s"
                         % (name, x.dtype))
    if x.dim() != (2 if nhwc else 3) or not x.is_contiguous():
        raise ValueError("%s expects a contiguous x %s, got %s"
                         % (name, "[M, C]" if nhwc else "[B, C, HW]",
                            tuple(x.shape)))
    c = x.shape[1]
    if w.dim() != 2 or w.shape[1] != c or w.dtype != x.dtype \
            or w.device != x.device:
        raise ValueError("%s: w must be [O, %d] %s on %s, got %s %s on %s"
                         % (name, c, x.dtype, x.device, tuple(w.shape),
                            w.dtype, w.device))
    o = w.shape[0]
    out_shape = (x.shape[0], o) if nhwc else (x.shape[0], o, x.shape[2])
    for an, t in acts:
        if tuple(t.shape) != out_shape or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous %s %s tensor on %s,"
                             " got %s %s on %s"
                             % (name, an, out_shape, x.dtype, x.device,
                                tuple(t.shape), t.dtype, t.device))
    for vn, t, n in vectors:
        if t is None:
            continue
        if tuple(t.shape) != (n,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous float32 [%d] tensor"
                             " on %s, got %s %s on %s"
                             % (name, vn, n, x.device, tuple(t.shape),
                                t.dtype, t.device))


def _w_tiles(rows, kdim, x):
    """Scratch for the NCHW kernels' W pre-pass: W as [rows, kdim] in
    128 x k-tile tiles of the wgmma layout, float32 as hi and lo TF32 (32
    KB a tile), bfloat16 as it is (16 KB)."""
    tiles = -(-rows // _TILE) * -(-kdim // _K_TILE[x.dtype])
    return torch.empty(tiles * _TILE * 128 * (2 if x.dtype == torch.float32
                                              else 1),
                       dtype=torch.uint8, device=x.device)


def _bn_vectors(mean, rstd, gamma, beta, apply_bn, c):
    names = ("mean", "rstd", "gamma", "beta")
    if not apply_bn:
        return [None] * 4, []
    vs = [mean, rstd, gamma, beta]
    return vs, [(n, v, c) for n, v in zip(names, vs)]


def _fwd(name, nhwc, x, w, mean, rstd, gamma, beta, shift, act, apply_bn,
         with_stats):
    n, hw, c, o, _, _ = _shapes(x, w, nhwc)
    bn, vec = _bn_vectors(mean, rstd, gamma, beta, apply_bn, c)
    if with_stats:
        vec.append(("shift", shift, o))
    _check(name, x, w, nhwc, vec, [])
    z = torch.empty((n, o) if nhwc else (x.shape[0], o, hw), dtype=x.dtype,
                    device=x.device)
    stats = torch.zeros((2, o), dtype=torch.float32, device=x.device)
    if n == 0 or c == 0:
        return z.zero_(), stats[0], stats[1]
    part = (torch.empty((2, -(-n // _TILE), o), dtype=torch.float32,
                        device=x.device) if with_stats else None)
    layout = (c, o) if nhwc else (hw, c, o)
    wsw = () if nhwc else (_w_tiles(o, c, x).data_ptr(),)
    err = _fwd_lib(nhwc)(
        x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1), *map(_ptr, bn),
        _ptr(shift) if with_stats else None, z.data_ptr(), _ptr(part),
        stats.data_ptr(), *wsw, n, *layout, int(bool(apply_bn)),
        int(act == "relu"), int(bool(with_stats)), _DTYPE_CODE[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "%s x%s w%s" % (name, tuple(x.shape), tuple(w.shape)))
    return z, stats[0], stats[1]


def _dw_splits(b, hw, c, o):
    """(splits, chunk) of the NCHW dW's contraction over the b * hw
    positions: whole images a chunk, about two waves of one block an SM
    over the (C, O) tiles, at least 256 positions a chunk (or all)."""
    tiles = -(-c // _TILE) * -(-o // _TILE)
    want = max(1, _DW_BLOCKS // tiles)
    images = min(b, max(-(-b // want), -(-_DW_MIN_CHUNK // hw)))
    return -(-b // images), images * hw


def _dw_splits_nhwc(n, c, o, dtype):
    """(splits, chunk) of the NHWC dW's contraction over the n positions:
    about two waves of one block an SM over the (C, O) tiles, chunks a
    multiple of the k tile and at least 256 positions."""
    step = _K_TILE[dtype]
    tiles = -(-c // _TILE) * -(-o // _TILE)
    want = max(1, _DW_BLOCKS // tiles)
    chunk = max(-(-n // want), _DW_MIN_CHUNK)
    chunk = -(-chunk // step) * step
    return -(-n // chunk), chunk


def _bwd(name, nhwc, x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta,
         shift, act, apply_bn, with_stats):
    n, hw, c, o, _, _ = _shapes(x, w, nhwc)
    bn, vec = _bn_vectors(mean, rstd, gamma, beta, apply_bn, c)
    acts = [("dz", dz)]
    if with_stats:
        vec += [("dsum", dsum, o), ("dsumsq", dsumsq, o),
                ("shift", shift, o)]
        acts.append(("z", z))
    _check(name, x, w, nhwc, vec, acts)
    dx = torch.empty_like(x)
    dw = torch.zeros((o, c), dtype=torch.float32, device=x.device)
    dgb = torch.zeros((2, c), dtype=torch.float32, device=x.device)
    if n == 0 or c == 0:
        return dx.zero_(), dw, dgb[0], dgb[1]
    splits, chunk = (_dw_splits_nhwc(n, c, o, x.dtype) if nhwc
                     else _dw_splits(x.shape[0], hw, c, o))
    dw_part = (torch.empty((splits, o, c), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    g_part = (torch.empty((2, -(-n // _TILE), c), dtype=torch.float32,
                          device=x.device) if apply_bn else None)
    stats = (dsum, dsumsq, shift) if with_stats else (None,) * 3
    layout = (c, o) if nhwc else (hw, c, o)
    wsw = () if nhwc else (_w_tiles(c, o, x).data_ptr(),)
    err = _bwd_lib(nhwc)(
        x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        _ptr(z) if with_stats else None, dz.data_ptr(), _ptr(stats[0]),
        _ptr(stats[1]), *map(_ptr, bn), _ptr(stats[2]), dx.data_ptr(),
        dw.data_ptr(), _ptr(dw_part), _ptr(g_part), dgb.data_ptr(), *wsw, n,
        *layout, int(bool(apply_bn)), int(act == "relu"),
        int(bool(with_stats)), splits, chunk, _DTYPE_CODE[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "%s x%s w%s" % (name, tuple(x.shape), tuple(w.shape)))
    return dx, dw, dgb[0], dgb[1]


def conv_bn_fwd(x, w, mean, rstd, gamma, beta, shift, act="relu",
                apply_bn=True, with_stats=True):
    """Launch kernel #8 (tensor cores) on CUDA tensors: x [B, C, HW], w
    [O, C] (any strides); returns (z [B, O, HW], sum [O], sumsq [O])."""
    out = _fwd("conv_bn_fwd", False, x, w, mean, rstd, gamma, beta, shift,
               act, apply_bn, with_stats)
    conv_bn_fwd.launches += 1
    return out


def conv_bn_bwd(x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift,
                act="relu", apply_bn=True, with_stats=True):
    """Launch kernel #9 (tensor cores) on CUDA tensors: x [B, C, HW], w
    [O, C], z and dz [B, O, HW]; returns (dx, dW [O, C], dgamma [C], dbeta
    [C]).  Every sum over positions is reduced in a fixed order: two runs
    give the same bits."""
    out = _bwd("conv_bn_bwd", False, x, w, z, dz, dsum, dsumsq, mean, rstd,
               gamma, beta, shift, act, apply_bn, with_stats)
    conv_bn_bwd.launches += 1
    return out


def conv_bn_fwd_nhwc(x, w, mean, rstd, gamma, beta, shift, act="relu",
                     apply_bn=True, with_stats=True):
    """Launch kernel #10 (tensor cores) on CUDA tensors: x [M, C], w [O, C]
    (any strides); returns (z [M, O], sum [O], sumsq [O])."""
    out = _fwd("conv_bn_fwd_nhwc", True, x, w, mean, rstd, gamma, beta,
               shift, act, apply_bn, with_stats)
    conv_bn_fwd_nhwc.launches += 1
    return out


def conv_bn_bwd_nhwc(x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta,
                     shift, act="relu", apply_bn=True, with_stats=True):
    """Launch kernel #11 (tensor cores) on CUDA tensors: x [M, C], w [O, C],
    z and dz [M, O]; returns (dx, dW [O, C], dgamma [C], dbeta [C]), every
    sum over positions reduced in a fixed order."""
    out = _bwd("conv_bn_bwd_nhwc", True, x, w, z, dz, dsum, dsumsq, mean,
               rstd, gamma, beta, shift, act, apply_bn, with_stats)
    conv_bn_bwd_nhwc.launches += 1
    return out


for _fn in (conv_bn_fwd, conv_bn_bwd, conv_bn_fwd_nhwc, conv_bn_bwd_nhwc):
    _fn.launches = 0


def forward(x, w, mean, rstd, gamma, beta, shift, act, apply_bn, with_stats,
            nhwc):
    """The fused layer's forward: kernel #8 (NCHW) or #10 (NHWC) for CUDA
    tensors, the plain version for CPU tensors."""
    args = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn, with_stats)
    if x.device.type == "cpu":
        return bn_act_matmul_reference(*args, nhwc=nhwc)
    return (conv_bn_fwd_nhwc if nhwc else conv_bn_fwd)(*args)


def backward(x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift, act,
             apply_bn, with_stats, nhwc):
    """The fused layer's backward: kernel #9 (NCHW) or #11 (NHWC) for CUDA
    tensors, the plain version for CPU tensors."""
    args = (x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift, act,
            apply_bn, with_stats)
    if x.device.type == "cpu":
        return bn_act_matmul_bwd_reference(*args, nhwc=nhwc)
    return (conv_bn_bwd_nhwc if nhwc else conv_bn_bwd)(*args)


def stats_grads(apply_bn, gamma, rstd, dgamma, dbeta):
    """Per-channel mean/var cotangents from dgamma/dbeta (the JAX
    package's ``conv_bn.stats_grads``): with the batch mean and variance as
    inputs of the layer, dmean = -rstd gamma dbeta and, through rstd =
    (var + eps)^-1/2, dvar = -gamma dgamma rstd^2 / 2."""
    if not apply_bn:
        z = torch.zeros_like(dbeta)
        return z, z
    g32, r32 = gamma.float(), rstd.float()
    return -r32 * g32 * dbeta, -0.5 * g32 * dgamma * r32 * r32


class _BnActMatmul(torch.autograd.Function):
    """Forward #8/#10, backward #9/#11 (the plain versions for CPU
    tensors): the JAX package's ``custom_vjp`` pair.  ``stats_shift`` gets
    no gradient; a stats cotangent that never arrives skips the fold."""

    @staticmethod
    def forward(ctx, x, w, mean, var, gamma, beta, shift, eps, act, apply_bn,
                with_stats, nhwc):
        w_oc = w.t() if nhwc else w
        rstd = torch.rsqrt(var.float() + eps)
        z, s, ss = forward(x, w_oc, mean.float(), rstd, gamma.float(),
                           beta.float(), shift.float(), act, apply_bn,
                           with_stats, nhwc)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, z, mean, rstd, gamma, beta, shift)
        ctx.cfg = (act, apply_bn, with_stats, nhwc)
        return z, s, ss

    @staticmethod
    def backward(ctx, dz, dsum, dsumsq):
        x, w, z, mean, rstd, gamma, beta, shift = ctx.saved_tensors
        act, apply_bn, with_stats, nhwc = ctx.cfg
        fold = with_stats and (dsum is not None or dsumsq is not None)
        if fold:
            zeros = torch.zeros_like(shift, dtype=torch.float32)
            dsum = zeros if dsum is None else dsum.float().contiguous()
            dsumsq = zeros if dsumsq is None else dsumsq.float().contiguous()
        dz = torch.zeros_like(z) if dz is None \
            else dz.to(x.dtype).contiguous()
        dx, dw, dgamma, dbeta = backward(
            x, w.t() if nhwc else w, z, dz, dsum, dsumsq, mean.float(), rstd,
            gamma.float(), beta.float(), shift.float(), act, apply_bn, fold,
            nhwc)
        dw = dw.to(w.dtype)
        dmean, dvar = stats_grads(apply_bn, gamma, rstd, dgamma, dbeta)
        return (dx, dw.t() if nhwc else dw, dmean.to(mean.dtype),
                dvar.to(mean.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype)) + (None,) * 6


def bn_act_matmul(x3, w, mean, var, gamma, beta, stats_shift, eps=1e-5,
                  act="relu", apply_bn=True, with_stats=True):
    """z[b] = W @ act(bn(x[b])) with fused output stats, NCHW: x3 [B, C,
    HW], w [O, C]; returns (z3 [B, O, HW], sum [O], sumsq [O]),
    differentiable in x3, w, mean, var, gamma and beta."""
    return _BnActMatmul.apply(x3, w, mean, var, gamma, beta, stats_shift,
                              eps, act, apply_bn, with_stats, False)


def bn_act_matmul_nhwc(x2, w, mean, var, gamma, beta, stats_shift, eps=1e-5,
                       act="relu", apply_bn=True, with_stats=True):
    """z = act(bn(x2)) @ w with fused output stats, NHWC: x2 [M, C], w [C,
    O] (the JAX API's layout; the kernels read it as [O, C] through its
    strides); returns (z2 [M, O], sum [O], sumsq [O])."""
    return _BnActMatmul.apply(x2, w, mean, var, gamma, beta, stats_shift,
                              eps, act, apply_bn, with_stats, True)
