"""``fused_attention`` (counterpart of ``paddle_tpu/ops/attention.py``).

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
applied as one output scale since it commutes with the PV product."""

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
