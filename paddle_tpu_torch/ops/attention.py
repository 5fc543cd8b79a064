"""``fused_attention`` and ``paged_attention`` (counterpart of
``paddle_tpu/ops/attention.py``).

Q/K/V are head-split [B, H, T, D]; ``KLen`` [B] masks padded keys and
``causal`` adds the autoregressive mask (top-aligned when Tq == Tk, suffix
when Tq < Tk: the KV-cache decode shape).  The op calls
``ops.cuda.flash_attention``: kernels #1 (forward) and #2 (backward) on
the card, their plain versions on the CPU.  The dropout hash key comes
from the op's index, so the generic grad's recompute (which passes the
forward op's index) regenerates the forward's mask.  Where the JAX
package makes the Pallas kernel opt-in behind ``FLAGS_pallas_kernels``
and falls back to XLA for shapes it cannot take, here the kernel is the
path on the card: a shape it cannot take raises.  A tuner's ruling
(``autotune.attention_choice``, per (Tq, Tk, d, dtype)) may send a shape
to the library arm instead, ``F.scaled_dot_product_attention``
(``flash_attention.library_attention``), except where the op drops
weights (no library call draws the kernel's dropout mask): there, and
with no ruling, the kernel runs.  The plain version runs only on the
CPU.
Eval-time dropout is ``downgrade_in_infer``: weights scale by (1 - p),
applied as one output scale since it commutes with the PV product.

``paged_attention`` gathers each slot's pages out of the pool (int8 pools
dequantized by their scales) into the contiguous [S, H, Tmax, D] the
kernel takes, then calls the same wrapper with ``KLen`` and the causal
suffix alignment: kernel #1 on the card (its one-row kernel at decode,
its tile kernel for the speculative verify's k-row queries).  The gather
is plain PyTorch, as the JAX package's is XLA outside its Pallas
kernel.  Its ruling is read at the gathered shape (Tk = the pages' tokens a
slot), as the JAX package reads it.

Under the mesh runtime with a populated ``sp`` axis and
``BuildStrategy.sequence_parallel`` (the plan marks the op with
``__ring_axis__``), the op lowers to ring attention
(``parallel/ring_attention.py``) exactly when the JAX package's test
passes (``_ring_applicable``): the sequence's length, known only at run
time, decides, so the op slices its inputs and gathers its output
itself.  Elsewhere kernel #1 runs on the whole sequence.

Under the mesh runtime a shard's (b, h) hash as the global tensor's rows
(``_hash_rows``: the shard's batch and head offsets and the global head
count, which kernels #1 and #2 and their plain versions take), so a
sharded run drops the single-device run's weights."""

import torch

from .. import autotune
from ..registry import in_var, register_op, set_output
from .cuda import flash_attention as fa


def _library_arm(q, k_shape, rate):
    """Whether a tuner's ruling sends this call to the library arm: on
    the card, without dropout, under a ``false`` ruling."""
    return (q.device.type == "cuda" and not rate
            and autotune.attention_choice(q.shape, k_shape, q.dtype)
            is False)


def _fused_attention_infer(op, block):
    q = in_var(op, block, "Q")
    k = in_var(op, block, "K")
    v = in_var(op, block, "V")
    if len(q.shape) != 4 or len(k.shape) != 4 or len(v.shape) != 4:
        raise ValueError(
            "fused_attention expects [B, H, T, D] Q/K/V, got %s/%s/%s"
            % (q.shape, k.shape, v.shape))
    if q.shape[3] != k.shape[3]:
        raise ValueError(
            "fused_attention Q/K head dims disagree: %s vs %s"
            % (q.shape, k.shape))
    if v.shape[2] != k.shape[2] or v.shape[3] != q.shape[3]:
        raise ValueError(
            "fused_attention V must be [B, H, Tk, D] matching K's length "
            "and Q's head dim: got Q %s, K %s, V %s"
            % (q.shape, k.shape, v.shape))
    if op.attrs.get("causal", False) and q.shape[2] > k.shape[2]:
        raise ValueError(
            "fused_attention: causal=True requires Tq <= Tk (got %d vs "
            "%d)" % (q.shape[2], k.shape[2]))
    set_output(op, block, "Out", q.shape, q.dtype)


def _hash_rows(q, attrs, ctx):
    """The dropout hash's (batch offset, head offset, global heads) of a
    shard the mesh runtime runs (``__shard_dims__`` on dims 0 and 1, set by
    ``ParallelExecutor``'s plan), so the shard draws its block of the
    global mask; None for the whole tensor."""
    rt = getattr(ctx, "mesh", None)
    dims = dict((int(d), tuple(axes)) for d, axes in
                attrs.get("__shard_dims__") or ())
    if rt is None or not dims:
        return None
    b, h = q.shape[0], q.shape[1]
    ax_b, ax_h = dims.get(0, ()), dims.get(1, ())
    return (rt.index(ax_b) * b if ax_b else 0,
            rt.index(ax_h) * h if ax_h else 0, h * rt.extent(ax_h))


def _fused_attention_compute(ins, attrs, ctx, op_index):
    q, k, v = (t.contiguous() for t in (ins["Q"][0], ins["K"][0],
                                        ins["V"][0]))
    k_len = ins.get("KLen", [None])[0]
    rate = float(attrs.get("dropout_rate", 0.0))
    is_test = attrs.get("is_test", False)
    post = None
    seed = None
    if rate and is_test:
        # downgrade_in_infer: weights *= (1-p) == output *= (1-p)
        post, rate = 1.0 - rate, 0.0
    elif rate:
        seed = ctx.seed32(op_index)
    rt = getattr(ctx, "mesh", None)
    axis = attrs.get("__ring_axis__")
    if axis and rt is not None and _ring_applicable(
            rt, axis, q.shape, k.shape, attrs.get("causal", False)):
        out = _ring_attention(rt, axis, q, k, v, k_len, seed,
                              attrs.get("causal", False), rate,
                              attrs.get("scale", None),
                              _hash_rows(q, attrs, ctx) if rate else None)
    elif _library_arm(q, k.shape, rate):
        out = fa.library_attention(q, k, v, k_len, attrs.get("causal", False),
                                   attrs.get("scale", None))
    else:
        out = fa.flash_attention(q, k, v, k_len, seed,
                                 attrs.get("causal", False), rate,
                                 attrs.get("scale", None),
                                 _hash_rows(q, attrs, ctx) if rate else None)
    if post is not None:
        out = out * torch.tensor(post, dtype=out.dtype)
    return {"Out": out}


def _ring_applicable(rt, axis, q_shape, k_shape, causal):
    """The ring lowers the op when the ``sp`` axis has more than one rank,
    its extent divides Tq and Tk, and a causal op has Tq == Tk (the JAX
    package's test); otherwise kernel #1 runs on the whole sequence, as
    the JAX package runs its single-chip kernel there."""
    sp = rt.extent((axis,))
    if sp <= 1:
        return False
    tq, tk = q_shape[2], k_shape[2]
    if tq % sp or tk % sp:
        return False
    return not (causal and tq != tk)


def _ring_attention(rt, axis, q, k, v, k_len, seed, causal, rate, scale,
                    rows):
    """Sequence-parallel attention over ``axis`` (``parallel/
    ring_attention.py``) of Q/K/V every ``sp`` rank holds whole: the rank
    keeps its time block of each, runs the ring, and the blocks of the
    output are gathered back (the backward slices the output's cotangent
    and gathers the inputs' gradients).  The batch rows and heads of a
    dp / tp shard hash at their global rows (``rows``)."""
    from ..parallel.collective import gather_replicated, slice_replicated
    from ..parallel.ring_attention import _ring

    axes = (axis,)
    blocks = [slice_replicated(rt, x, axes, 2) for x in (q, k, v)]
    out = _ring(*blocks, k_len, seed, rt, axis, causal, scale, rate, rows)
    return gather_replicated(rt, out, axes, 2)


register_op("fused_attention", ["Q", "K", "V", "KLen"], ["Out"],
            infer=_fused_attention_infer, compute=_fused_attention_compute,
            no_grad_inputs=("KLen",), stateful_random=True)


# ---------------------------------------------------------------------------
# paged attention: attention over a block-indexed KV pool
# ---------------------------------------------------------------------------

def gather_pages(pool, table, scale=None, index=None):
    """Each slot's K or V out of a paged pool, as the JAX package's
    ``gather_pages``: ``pool`` [P, H, ps, D] (float, or int8 with ``scale``
    [P, H, ps] float32), ``table`` [S, max_pages] page ids; returns [S, H,
    max_pages * ps, D] contiguous, float32 for an int8 pool (values times
    their row's scale).  One gather: the pages are indexed by (slot, head,
    page) at once, so the result is laid out without a second copy.  A
    table entry out of the pool (the sentinel of an unheld page) reads a
    clamped page, as XLA's gather does; ``k_len`` masks what it reads.
    ``index`` is ``_gather_index``'s, when the caller has it."""
    s, mp = table.shape
    p, h, ps, d = pool.shape
    pages, heads = index or _gather_index(table, p, h, pool.device)
    kv = pool[pages, heads].reshape(s, h, mp * ps, d)
    if pool.dtype == torch.int8:
        sc = scale[pages, heads].reshape(s, h, mp * ps)
        # int8 times float32 promotes to float32 in one pass: the values
        # as floats times their scales
        kv = torch.mul(kv, sc[..., None])
    return kv


def _gather_index(table, n_pages, n_head, device):
    """(pages [S, 1, max_pages], heads [1, H, 1]) long index tensors of a
    gather: the table's page ids clamped into the pool."""
    from .kv_cache import _clamp_index

    pages = _clamp_index(table.to(device), n_pages).long()[:, None, :]
    return pages, torch.arange(n_head, device=device)[None, :, None]


def _paged_attention_infer(op, block):
    q = in_var(op, block, "Q")
    kc = in_var(op, block, "KCache")
    table = in_var(op, block, "PageTable")
    if q is None or kc is None or table is None:
        raise ValueError("paged_attention needs Q, KCache/VCache and "
                         "PageTable inputs")
    if len(q.shape) != 4 or len(kc.shape) != 4 or len(table.shape) != 2:
        raise ValueError(
            "paged_attention expects Q [S, H, Tq, D], KCache "
            "[P, H, ps, D], PageTable [S, max_pages]; got %s / %s / %s"
            % (q.shape, kc.shape, table.shape))
    tmax = table.shape[1] * kc.shape[2]
    if q.shape[2] > tmax:
        raise ValueError(
            "paged_attention: Tq %d exceeds the paged capacity %d"
            % (q.shape[2], tmax))
    if kc.dtype == torch.int8 and in_var(op, block, "KScale") is None:
        raise ValueError(
            "paged_attention: int8 KV pools need KScale/VScale inputs")
    set_output(op, block, "Out", q.shape, q.dtype)


def _paged_attention_compute(ins, attrs, ctx, op_index):
    q = ins["Q"][0]
    table = ins["PageTable"][0]
    pool = ins["KCache"][0]
    args = (table, pool.shape[0], pool.shape[1], pool.device)
    # the K and V gathers of every layer share one index a run
    index = (_gather_index(*args) if ctx is None else ctx.shared_value(
        ("paged_gather",) + args[1:], (table,),
        lambda: _gather_index(*args)))
    k = gather_pages(pool, table, ins.get("KScale", [None])[0], index)
    v = gather_pages(ins["VCache"][0], table, ins.get("VScale", [None])[0],
                     index)
    k, v = k.to(q.dtype), v.to(q.dtype)
    args = (ins.get("KLen", [None])[0], attrs.get("causal", True))
    if _library_arm(q, k.shape, 0.0):
        out = fa.library_attention(q, k, v, *args, attrs.get("scale", None))
    else:
        out = fa.flash_attention(q.contiguous(), k, v, args[0], None, args[1],
                                 0.0, attrs.get("scale", None))
    return {"Out": out}


register_op("paged_attention",
            ["Q", "KCache", "VCache", "PageTable", "KLen", "KScale",
             "VScale"], ["Out"],
            infer=_paged_attention_infer, compute=_paged_attention_compute,
            grad=None)
