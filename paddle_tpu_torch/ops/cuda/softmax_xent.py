"""Fused softmax + cross-entropy, forward (kernel #5) and backward
(kernel #6), each beside its plain PyTorch version.

``softmax_xent_fwd`` and ``softmax_xent_bwd`` launch the two kernels of
``csrc/softmax_xent.cu`` (the Hopper port of
``paddle_tpu/ops/pallas/softmax_xent.py``'s ``_fwd`` and ``_bwd``) on
CUDA tensors; ``softmax_xent_reference`` and
``softmax_xent_bwd_reference`` are the plain versions.  ``softmax_xent``
is what the op calls: one ``torch.autograd.Function`` whose forward and
backward launch the kernels for tensors on the card, run the plain
versions for tensors on the CPU, and raise for anything else.

Over rows of logits [N, C] with hard labels [N] (int64), uniform label
smoothing ``eps`` fused in:

    loss    = (1 - eps) (logZ - x[label]) + eps (logZ - mean(x))
    softmax = exp(x - logZ)
    dlogits = (softmax - target) dloss + softmax (dsm - sum(dsm softmax))

with target = (1 - eps) onehot(label) + eps / C.  As in the TPU kernel's
``iota`` compare, a label outside [0, C) matches no column: its row picks
0 and has no onehot term, and nothing is read out of bounds.  ``dsm`` (the
cotangent of the softmax output) may be None, meaning zero; the
Transformer's step passes None, which spares the backward a read of an
[N, C] tensor of zeros.
"""

import ctypes

import torch

from . import build

__all__ = ["softmax_xent", "softmax_xent_fwd", "softmax_xent_bwd",
           "softmax_xent_reference", "softmax_xent_bwd_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _picked_and_onehot_index(label, c):
    """(in-range mask [N], label clamped into [0, C)) for gathering
    without an out-of-bounds read."""
    lbl = label.reshape(-1).long()
    return (lbl >= 0) & (lbl < c), lbl.clamp(0, c - 1)


def softmax_xent_reference(logits, label, eps=0.0):
    """(loss [N, 1], softmax [N, C]) in logits' dtype, computed in
    float32."""
    x = logits.float()
    c = x.shape[1]
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    s = e.sum(dim=-1, keepdim=True)
    log_z = torch.log(s) + m
    ok, idx = _picked_and_onehot_index(label, c)
    picked = torch.where(ok[:, None], x.gather(1, idx[:, None]), 0.0)
    loss = log_z - picked
    if eps:
        loss = (1.0 - eps) * loss + eps * (log_z - x.mean(dim=-1,
                                                           keepdim=True))
    return loss.to(logits.dtype), (e / s).to(logits.dtype)


def softmax_xent_bwd_reference(softmax, label, dloss, dsm=None, eps=0.0):
    """dlogits [N, C] in softmax's dtype, computed in float32."""
    sm = softmax.float()
    n, c = sm.shape
    g = dloss.float().reshape(n, 1)
    target = torch.full_like(sm, eps / c)
    ok, idx = _picked_and_onehot_index(label, c)
    rows = torch.arange(n, device=sm.device)[ok]
    target[rows, idx[ok]] += 1.0 - eps
    out = (sm - target) * g
    if dsm is not None:
        dsm = dsm.float()
        out = out + sm * (dsm - (dsm * sm).sum(dim=-1, keepdim=True))
    return out.to(softmax.dtype)


# kernel #5's launch (``csrc/softmax_xent.cu``): threads a block, the
# blocks an SM holds, the portable cluster size, the row values a thread
# keeps in registers
_NT, _BLOCKS_PER_SM, _MAX_CLUSTER, _VALUES = 256, 4, 8, 32


def _fwd_plan(n, c, itemsize, sms):
    """(cluster blocks a row, 16-byte chunks a thread) that kernel #5
    launches n rows of c values with on a card of ``sms`` SMs; (0, 0) is
    the streaming path (a block a row, two passes).  A row has at most
    qmax chunks (a misaligned start adds one): the fewest blocks whose
    registers hold them, doubled while the grid stays within a wave and
    each block keeps a chunk a thread, then the fewest chunks a thread."""
    ve = 16 // itemsize
    qmax = (c + 2 * ve - 2) // ve
    cl = -(-qmax // (_NT * (_VALUES // ve)))
    if cl > _MAX_CLUSTER:
        return 0, 0
    while cl * 2 <= _MAX_CLUSTER and n * cl * 2 <= _BLOCKS_PER_SM * sms \
            and qmax >= cl * 2 * _NT:
        cl *= 2
    ch = 1
    while _NT * ch * cl < qmax:
        ch *= 2
    return cl, ch


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise ValueError("%s must be a contiguous %s %s tensor on %s, got "
                         "%s %s on %s" % (name, tuple(shape), dtype, device,
                                          tuple(t.shape), t.dtype,
                                          t.device))


def _lib(name):
    fn = getattr(build.library("softmax_xent"), "ptt_" + name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "softmax_xent_fwd":  # ..., dtype, cluster, chunks, ...
            fn.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, i, i, i, p]
        else:
            fn.argtypes = [p] * 5 + [i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    return fn


def softmax_xent_fwd(logits, label, eps=0.0):
    """Launch kernel #5 on CUDA tensors logits [N, C] (float32 or
    bfloat16), label [N] int64; returns (loss [N, 1], softmax [N, C])."""
    if logits.device.type != "cuda":
        raise ValueError("softmax_xent_fwd runs on CUDA tensors, got %s"
                         % logits.device)
    if logits.dim() != 2 or logits.dtype not in _DTYPE_CODE \
            or not logits.is_contiguous():
        raise ValueError("softmax_xent_fwd expects contiguous float32 or "
                         "bfloat16 logits [N, C], got %s %s"
                         % (tuple(logits.shape), logits.dtype))
    n, c = logits.shape
    _check("softmax_xent_fwd: label", label, (n,), torch.int64,
           logits.device)
    loss = torch.empty((n, 1), dtype=logits.dtype, device=logits.device)
    softmax = torch.empty_like(logits)
    if n == 0 or c == 0:
        return loss, softmax
    cluster, chunks = _fwd_plan(
        n, c, logits.element_size(),
        torch.cuda.get_device_properties(logits.device).multi_processor_count)
    err = _lib("softmax_xent_fwd")(
        logits.data_ptr(), label.data_ptr(), loss.data_ptr(),
        softmax.data_ptr(), n, c, float(eps), _DTYPE_CODE[logits.dtype],
        cluster, chunks, logits.device.index,
        torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "softmax_xent_fwd logits%s" % (tuple(logits.shape),))
    softmax_xent_fwd.launches += 1
    return loss, softmax


softmax_xent_fwd.launches = 0


def softmax_xent_bwd(softmax, label, dloss, dsm=None, eps=0.0):
    """Launch kernel #6 on CUDA tensors: dlogits [N, C] from the forward's
    softmax, label [N] int64, dloss [N, 1] and the optional dsm [N, C]
    (None = zero: the kernel then reads no [N, C] cotangent)."""
    if softmax.device.type != "cuda":
        raise ValueError("softmax_xent_bwd runs on CUDA tensors, got %s"
                         % softmax.device)
    if softmax.dim() != 2 or softmax.dtype not in _DTYPE_CODE \
            or not softmax.is_contiguous():
        raise ValueError("softmax_xent_bwd expects a contiguous float32 or "
                         "bfloat16 softmax [N, C], got %s %s"
                         % (tuple(softmax.shape), softmax.dtype))
    n, c = softmax.shape
    dev = softmax.device
    _check("softmax_xent_bwd: label", label, (n,), torch.int64, dev)
    _check("softmax_xent_bwd: dloss", dloss, (n, 1), softmax.dtype, dev)
    if dsm is not None:
        _check("softmax_xent_bwd: dsm", dsm, (n, c), softmax.dtype, dev)
    dlogits = torch.empty_like(softmax)
    if n == 0 or c == 0:
        return dlogits
    err = _lib("softmax_xent_bwd")(
        softmax.data_ptr(), label.data_ptr(), dloss.data_ptr(),
        dsm.data_ptr() if dsm is not None else None, dlogits.data_ptr(),
        n, c, float(eps), _DTYPE_CODE[softmax.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "softmax_xent_bwd softmax%s" % (tuple(softmax.shape),))
    softmax_xent_bwd.launches += 1
    return dlogits


softmax_xent_bwd.launches = 0


class _SoftmaxXent(torch.autograd.Function):
    """Kernel #5 forward, kernel #6 backward (the plain versions for CPU
    tensors); the JAX package's ``custom_vjp`` pair.  Missing cotangents
    arrive as None, not as zero tensors."""

    @staticmethod
    def forward(ctx, logits, label, eps):
        ctx.set_materialize_grads(False)
        if logits.device.type == "cpu":
            loss, softmax = softmax_xent_reference(logits, label, eps)
        else:
            loss, softmax = softmax_xent_fwd(logits, label, eps)
        ctx.save_for_backward(softmax, label)
        ctx.eps = eps
        return loss, softmax

    @staticmethod
    def backward(ctx, dloss, dsm):
        softmax, label = ctx.saved_tensors
        if dloss is None and dsm is None:
            return None, None, None
        if dloss is None:
            dloss = torch.zeros((softmax.shape[0], 1), dtype=softmax.dtype,
                                device=softmax.device)
        args = (softmax, label, dloss.reshape(-1, 1).contiguous(),
                None if dsm is None else dsm.contiguous(), ctx.eps)
        if softmax.device.type == "cpu":
            return softmax_xent_bwd_reference(*args), None, None
        return softmax_xent_bwd(*args), None, None


def softmax_xent(logits, label, eps=0.0):
    """The op's entry, differentiable in logits: kernels #5/#6 for CUDA
    tensors, the plain versions for CPU tensors.  Returns (loss [N, 1],
    softmax [N, C])."""
    return _SoftmaxXent.apply(logits, label, eps)
