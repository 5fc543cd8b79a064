"""Ring attention: sequence (context) parallelism over the mesh's ``sp``
axis (counterpart of ``paddle_tpu/parallel/ring_attention.py``).

The sequence axis is split over ``sp``: each rank keeps its query block
and the key/value blocks travel around the ring, one point-to-point hop
a step (``MeshRuntime.shift``: rank j sends to j - 1 and receives from
j + 1), while the softmax accumulates online (running max ``m``, running
denominator ``l``).  A rank holds O(T/n x T/n) scores instead of
O(T^2).  Scores and the statistics accumulate in float32, also for bf16
inputs; the block products are ``torch.matmul``, as the JAX ring's are
``einsum`` outside any Pallas kernel.

Masks use GLOBAL query and key positions, and the dropout keep-mask is
the counter hash of ``ops/cuda/flash_attention.keep_mask`` on the global
(batch * head) rows, so a ring run drops exactly the weights a
single-device run drops (``downgrade_in_infer``: masked after ``l`` is
summed, not upscaled).  A fully masked row's weights are zeroed and the
output is divided by ``max(l, 1e-20)``.

Where the JAX package differentiates the ``fori_loop`` + ``ppermute``
loop, the port writes the backward as a second ring
(``torch.autograd.Function``): the K/V blocks rotate again with their
dK/dV accumulators, which take one hop more to reach their owner; each
block's probabilities are recomputed from the forward's saved row
statistics, and delta = rowsum(dO * O) holds under the dropout mask (the
arithmetic of ``flash_attention.attention_bwd_reference``).

Public surface:

* ``ring_attention(q, k, v, mesh, axis='sp', causal=False, scale=None,
  batch_axis=None)``: q/k/v are the global [B, H, T, D] tensors (alike on
  every rank); the rank keeps its time block (and its batch block over
  ``batch_axis``), runs the ring, and the result comes back global on
  every rank;
* ``ring_attention_shard(q, k, v, runtime, ...)``: the per-rank body on
  the rank's own blocks (what ``fused_attention`` runs under the mesh
  runtime);
* ``ring_block_step`` / ``ring_block_mask`` / ``ring_finish``: one step of
  the online softmax, a block's mask and the end, the functions the body
  calls (a test harness can play the rotation itself).
"""

import torch

from ..ops.cuda import flash_attention as fa
from .mesh import AXIS_SP

__all__ = ["ring_attention", "ring_attention_shard", "ring_block_step",
           "ring_block_mask", "ring_finish"]

_NEG_INF = -1e30


def ring_block_mask(q_pos, k_pos, k_len, causal, b):
    """The valid-key mask [B|1, 1, Tq, Tk] of one block at the global
    query and key positions ``q_pos`` / ``k_pos`` (None when nothing is
    masked)."""
    valid = None
    if k_len is not None:
        valid = k_pos[None, None, None, :] < \
            k_len.to(torch.int64).reshape(b, 1, 1, 1)
    if causal:
        c = (q_pos[:, None] >= k_pos[None, :])[None, None]
        valid = c if valid is None else valid & c
    return valid


def ring_block_step(qs, k_blk, v_blk, m, l, o, valid=None, keep=None):
    """One ring step: the online softmax over one K/V block.  ``qs`` is Q
    in float32 times the scale; ``m``/``l`` [B, H, Tq, 1] and ``o`` [B, H,
    Tq, D] the running max, denominator and output (float32); ``valid``
    the block's key mask, ``keep`` its dropout keep-mask.  Returns the new
    (m, l, o)."""
    s = torch.matmul(qs, k_blk.float().transpose(-1, -2))
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    if valid is not None:
        # a fully masked row keeps m_new == -1e30, so exp(s - m_new) is
        # 1 at every masked key: zeroed explicitly
        p = torch.where(valid, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    o = o * corr + torch.matmul(p, v_blk.float())
    return m_new, l, o


def ring_finish(o, l):
    """The float32 output of a finished ring: O / max(l, 1e-20)."""
    return o / l.clamp_min(1e-20)


def _bh_rows(b, h, rows, device):
    b0, h0, hg = fa.hash_rows(rows, h)
    return ((torch.arange(b, device=device) + b0)[:, None] * hg
            + torch.arange(h, device=device) + h0).reshape(b, h, 1, 1)


class _Ring(torch.autograd.Function):
    """The ring forward and its backward ring (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, k_len, seed, rt, axis, causal, scale, rate,
                rows):
        axes = (axis,)
        n, idx = rt.extent(axes), rt.index(axes)
        b, h, tq, d = q.shape
        tk = k.shape[2]
        dev = q.device
        scale = scale if scale is not None else 1.0 / (d ** 0.5)
        qs = q.float() * scale
        q_pos = idx * tq + torch.arange(tq, device=dev)
        bh = _bh_rows(b, h, rows, dev) if rate else None
        m = torch.full((b, h, tq, 1), _NEG_INF, device=dev)
        l = torch.zeros((b, h, tq, 1), device=dev)
        o = torch.zeros((b, h, tq, d), device=dev)
        k_blk, v_blk = k, v
        for i in range(n):
            k_pos = ((idx + i) % n) * tk + torch.arange(tk, device=dev)
            valid = ring_block_mask(q_pos, k_pos, k_len, causal, b)
            keep = fa.keep_mask(seed, bh, q_pos[:, None], k_pos[None, :],
                                rate) if rate else None
            m, l, o = ring_block_step(qs, k_blk, v_blk, m, l, o, valid,
                                      keep)
            # the last step's rotation would be discarded: n - 1 hops
            # move every block everywhere
            if i < n - 1:
                k_blk, v_blk = rt.shift([k_blk, v_blk], axes, -1)
        out = ring_finish(o, l)
        ctx.save_for_backward(q, k, v, k_len, out, m, l)
        ctx.cfg = (seed, rt, axis, causal, scale, rate, rows)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, k_len, out, m, l = ctx.saved_tensors
        seed, rt, axis, causal, scale, rate, rows = ctx.cfg
        axes = (axis,)
        n, idx = rt.extent(axes), rt.index(axes)
        b, h, tq, d = q.shape
        tk = k.shape[2]
        dev = q.device
        qs = q.float() * scale
        do = dout.float()
        q_pos = idx * tq + torch.arange(tq, device=dev)
        bh = _bh_rows(b, h, rows, dev) if rate else None
        delta = (do * out).sum(dim=-1, keepdim=True)
        inv_l = 1.0 / l.clamp_min(1e-20)
        dq = torch.zeros((b, h, tq, d), device=dev)
        dk = torch.zeros((b, h, tk, d), device=dev)
        dv = torch.zeros((b, h, tk, d), device=dev)
        k_blk, v_blk = k, v
        for i in range(n):
            k_pos = ((idx + i) % n) * tk + torch.arange(tk, device=dev)
            valid = ring_block_mask(q_pos, k_pos, k_len, causal, b)
            s = torch.matmul(qs, k_blk.float().transpose(-1, -2))
            p = torch.exp(s - m) * inv_l
            if valid is not None:
                p = torch.where(valid, p, 0.0)
            g = torch.matmul(do, v_blk.float().transpose(-1, -2))
            p_drop = p
            if rate:
                keep = fa.keep_mask(seed, bh, q_pos[:, None],
                                    k_pos[None, :], rate)
                g = torch.where(keep, g, 0.0)
                p_drop = torch.where(keep, p, 0.0)
            ds = p * (g - delta)
            dv = dv + torch.matmul(p_drop.transpose(-1, -2), do)
            dk = dk + torch.matmul(ds.transpose(-1, -2), qs)
            dq = dq + torch.matmul(ds, k_blk.float())
            if i < n - 1:
                k_blk, v_blk, dk, dv = rt.shift([k_blk, v_blk, dk, dv],
                                                axes, -1)
            else:
                # the accumulators take one hop more, home to their owner
                dk, dv = rt.shift([dk, dv], axes, -1)
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None)


def _ring(q, k, v, k_len, seed, rt, axis, causal, scale, rate, rows):
    if rate and seed is None:
        seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
    return _Ring.apply(q, k, v, k_len, seed, rt, axis, bool(causal), scale,
                       float(rate or 0.0), rows)


def ring_attention_shard(q, k, v, runtime, axis_name=AXIS_SP, causal=False,
                         scale=None, k_len=None, dropout_rate=0.0, seed=None,
                         batch_axis_name=None, head_axis_name=None):
    """The per-rank ring body: q [B, H, Tq, D] the rank's query block, k/v
    [B, H, Tk, D] its key/value blocks; returns its output block [B, H,
    Tq, D] in q's dtype.  ``runtime`` is the rank's
    ``collective.MeshRuntime``.

    ``k_len`` [B] masks padded keys (global valid-key counts of the rank's
    batch rows); ``dropout_rate``/``seed`` (a one-element int32 tensor,
    ``flash_attention.seed_tensor``) drop weights by the single-device
    counter hash.  ``batch_axis_name`` / ``head_axis_name`` name the axes
    the batch and the heads are split over, so the hash takes the global
    (batch * head) row."""
    b, h = q.shape[0], q.shape[1]
    rows = None
    if batch_axis_name is not None or head_axis_name is not None:
        ba = (batch_axis_name,) if batch_axis_name else ()
        ha = (head_axis_name,) if head_axis_name else ()
        rows = (runtime.index(ba) * b if ba else 0,
                runtime.index(ha) * h if ha else 0,
                h * runtime.extent(ha))
    return _ring(q, k, v, k_len, seed, runtime, axis_name, causal, scale,
                 dropout_rate, rows)


def ring_attention(q, k, v, mesh, axis=AXIS_SP, causal=False, scale=None,
                   batch_axis=None):
    """Context-parallel attention over ``mesh``'s ``axis``: q/k/v are the
    global [B, H, T, D] tensors, T divisible by the axis's extent (and B
    by ``batch_axis``'s).  Every rank of the world calls it; each returns
    the global [B, H, T, D] result, differentiable."""
    from . import distributed
    from .collective import MeshRuntime, gather_replicated, \
        slice_replicated

    if axis not in mesh.axis_names:
        raise ValueError("mesh has no axis %r (axes: %s)"
                         % (axis, mesh.axis_names))
    if batch_axis is not None:
        if batch_axis not in mesh.axis_names:
            raise ValueError("mesh has no axis %r (axes: %s)"
                             % (batch_axis, mesh.axis_names))
        if batch_axis == axis:
            raise ValueError(
                "batch_axis must differ from the sequence axis %r" % axis)
    rt = MeshRuntime(mesh, distributed.process_id(), q.device)
    axes = [(axis,)] + ([(batch_axis,)] if batch_axis else [])
    rt.prepare(axes)
    blocks = []
    for x in (q, k, v):
        x = slice_replicated(rt, x, (axis,), 2)
        if batch_axis:
            x = slice_replicated(rt, x, (batch_axis,), 0)
        blocks.append(x)
    out = ring_attention_shard(*blocks, rt, axis_name=axis, causal=causal,
                               scale=scale, batch_axis_name=batch_axis)
    if batch_axis:
        out = gather_replicated(rt, out, (batch_axis,), 0)
    return gather_replicated(rt, out, (axis,), 2)
