"""``fused_attention`` and ``paged_attention`` (counterpart of
``paddle_tpu/ops/attention.py``).

Q/K/V are head-split [B, H, T, D]; ``KLen`` [B] masks padded keys and
``causal`` adds the autoregressive mask (top-aligned when Tq == Tk, suffix
when Tq < Tk: the KV-cache decode shape).  The op calls
``ops.cuda.flash_attention``: kernels #1 (forward) and #2 (backward) on
the card, their plain versions on the CPU.  The dropout hash key comes
from the op's index, so the generic grad's recompute (which passes the
forward op's index) regenerates the forward's mask.  Where the JAX package makes the Pallas kernel opt-in behind
``FLAGS_pallas_kernels`` and falls back to XLA for shapes it cannot take,
here the kernel is the path on the card: a shape it cannot take raises.
Eval-time dropout is ``downgrade_in_infer``: weights scale by (1 - p),
applied as one output scale since it commutes with the PV product.

``paged_attention`` gathers each slot's pages out of the pool (int8 pools
dequantized by their scales) into the contiguous [S, H, Tmax, D] the
kernel takes, then calls the same wrapper with ``KLen`` and the causal
suffix alignment: kernel #1 on the card (its one-row kernel at decode,
its tile kernel for the speculative verify's k-row queries).  The gather
is plain PyTorch, as the JAX package's is XLA outside its Pallas
kernel."""

import torch

from ..registry import in_var, register_op, set_output
from .cuda import flash_attention as fa


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
    out = fa.flash_attention(q, k, v, k_len, seed, attrs.get("causal", False),
                             rate, attrs.get("scale", None))
    if post is not None:
        out = out * torch.tensor(post, dtype=out.dtype)
    return {"Out": out}


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
    out = fa.flash_attention(q.contiguous(), k.to(q.dtype), v.to(q.dtype),
                             ins.get("KLen", [None])[0], None,
                             attrs.get("causal", True), 0.0,
                             attrs.get("scale", None))
    return {"Out": out}


register_op("paged_attention",
            ["Q", "KCache", "VCache", "PageTable", "KLen", "KScale",
             "VScale"], ["Out"],
            infer=_paged_attention_infer, compute=_paged_attention_compute,
            grad=None)
