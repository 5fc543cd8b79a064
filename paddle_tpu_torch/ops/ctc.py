"""``warpctc``, ``ctc_align`` and ``edit_distance`` (counterpart of
``paddle_tpu/ops/ctc.py``).

``warpctc`` is the blank-interleaved alpha recursion in log space: a loop
of T - 1 trips over the whole batch on [B, 2U + 1] alphas, with impossible
states at ``_NEG_INF`` (-1e30) as in the JAX op; the states'
log-probabilities are gathered once for every step, with a backward that
adds the repeated blank's gradients in a fixed order (``_GatherLast``).
Its ``logaddexp`` is ``log_add_exp``, whose gradient is the JAX one's
(``exp(x - out)`` for each input): where every term sits at the floor
the output absorbs the log 2, and both inputs get gradient 1, where
``torch.logaddexp``'s would give each 1/2.  The gradient is autograd
through the recursion.

``ctc_align`` compacts the kept tokens to the left of each row by an
exclusive count; the dropped ones write a spare column that is cut off.
``edit_distance`` runs the Levenshtein table one row a trip over the whole
batch: within a row, ``row[j] = j + cummin(cand[k] - k)`` is the
left-to-right minimum, in exact integer-valued float32.
"""

import torch

from ..registry import in_var, register_op, set_output
from .manipulation import add_at
from .sequence import _time_mask

_NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp``: max + log1p(exp(-|x1 - x2|)), x1 + x2 where the
    difference is NaN (infinities of one sign); gradients g * exp(x - out)
    with infinities read as 0."""

    @staticmethod
    def forward(ctx, x1, x2):
        amax = torch.maximum(x1, x2)
        delta = x1 - x2
        out = torch.where(torch.isnan(delta), x1 + x2,
                          amax + torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors

        def fin(x):
            return torch.where(torch.isinf(x), 0.0, x)

        o = fin(out)
        return g * torch.exp(fin(x1) - o), g * torch.exp(fin(x2) - o)


class _GatherLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx)`` whose backward adds the repeated
    indices' gradients in a fixed order (``manipulation.add_at``: sorted
    on the card), where ``gather``'s own backward adds them with atomics
    in whatever order they land: the blank repeats at every other state,
    so a captured step would not repeat the eager bits."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n = ctx.shape[-1]
        rows = torch.arange(idx.numel() // idx.shape[-1],
                            device=idx.device)[:, None] * n
        flat = (rows + idx.reshape(-1, idx.shape[-1])).reshape(-1)
        grad = add_at(g.new_zeros(ctx.shape.numel()), flat, g.reshape(-1))
        return grad.reshape(ctx.shape), None


def log_add_exp(x1, x2):
    x1, x2 = torch.broadcast_tensors(*(
        x if isinstance(x, torch.Tensor) else torch.full_like(x1, x)
        for x in (x1, x2)))
    return _LogAddExp.apply(x1, x2)


# -- warpctc ----------------------------------------------------------------

def ctc_nll(logits, t_len, label, u_len, blank):
    """[B] CTC negative log-likelihoods: logits [B, T, C], label [B, U]."""
    b, t_max, _ = logits.shape
    u_max = label.shape[1]
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    s_max = 2 * u_max + 1
    lbl = label.long()
    ext = torch.full((b, s_max), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lbl
    prev = torch.cat([torch.full_like(lbl[:, :1], -1), lbl[:, :-1]], 1)
    can_skip = torch.zeros((b, s_max), dtype=torch.bool, device=dev)
    can_skip[:, 1::2] = lbl != prev
    u_len = u_len.long()
    s_eff = 2 * u_len + 1
    s_idx = torch.arange(s_max, device=dev)[None]
    valid_s = s_idx < s_eff[:, None]
    t_valid = _time_mask(t_len, t_max, 0)

    floor = torch.full((b, s_max), _NEG_INF, dtype=logp.dtype, device=dev)
    # every step's log-probabilities of the extended label's states
    lp = _GatherLast.apply(logp, ext[:, None, :].expand(b, t_max, s_max)
                           .contiguous())                 # [B, T, S]
    alpha = torch.where(s_idx == 0, lp[:, 0], floor)
    alpha = torch.where((s_idx == 1) & (u_len[:, None] > 0), lp[:, 0],
                        alpha)
    pad1 = floor[:, :1]
    pad2 = floor[:, :2]
    for i in range(1, t_max):
        a1 = torch.cat([pad1, alpha[:, :-1]], 1)
        a2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                         _NEG_INF)
        merged = log_add_exp(log_add_exp(alpha, a1), a2)
        nxt = merged + lp[:, i]
        nxt = torch.where(valid_s, nxt, _NEG_INF)
        alpha = torch.where(t_valid[:, i, None], nxt, alpha)
    last = torch.gather(alpha, 1, torch.clamp_min(s_eff - 1, 0)[:, None])
    before = torch.gather(alpha, 1, torch.clamp_min(s_eff - 2, 0)[:, None])
    before = torch.where(u_len[:, None] > 0, before, _NEG_INF)
    return -log_add_exp(last, before)[:, 0]


def _warpctc_infer(op, block):
    x = in_var(op, block, "Logits")
    set_output(op, block, "Loss", (x.shape[0], 1), x.dtype)


def _warpctc_compute(ins, attrs, ctx, op_index):
    logits = ins["Logits"][0]
    t_len = ins["LogitsLength"][0]
    label = ins["Label"][0]
    if label.dim() == 3:
        label = label[:, :, 0]
    loss = ctc_nll(logits.to(torch.float32), t_len, label,
                   ins["LabelLength"][0], int(attrs.get("blank", 0)))
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp_min(t_len, 1).to(loss.dtype)
    return {"Loss": loss[:, None]}


register_op("warpctc", ["Logits", "LogitsLength", "Label", "LabelLength"],
            ["Loss"], infer=_warpctc_infer, compute=_warpctc_compute,
            no_grad_inputs=("LogitsLength", "Label", "LabelLength"))


# -- ctc_align --------------------------------------------------------------

def _ctc_align_infer(op, block):
    x = in_var(op, block, "Input")
    set_output(op, block, "Output", x.shape, x.dtype, lod_level=1)
    set_output(op, block, "OutputLength", (x.shape[0],), "int32")


def _ctc_align_compute(ins, attrs, ctx, op_index):
    x = ins["Input"][0]
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, :, 0]
    b, t = x.shape
    blank = int(attrs.get("blank", 0))
    keep = (x != blank) & _time_mask(ins["Length"][0], t, 0)
    if attrs.get("merge_repeated", True):
        keep = keep & (x != torch.cat([torch.full_like(x[:, :1], -1),
                                       x[:, :-1]], 1))
    pos = torch.where(keep, torch.cumsum(keep.long(), 1) - 1, t)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    out = x.new_zeros((b, t + 1)).index_put((rows, pos), x)[:, :t]
    if squeeze:
        out = out[:, :, None]
    return {"Output": out, "OutputLength": keep.sum(1).to(torch.int32)}


register_op("ctc_align", ["Input", "Length"], ["Output", "OutputLength"],
            infer=_ctc_align_infer, compute=_ctc_align_compute, grad=None)


# -- edit_distance ----------------------------------------------------------

def edit_distances(hyps, h_len, refs, r_len):
    """[B] float32 Levenshtein distances of the hyps' and refs' prefixes."""
    b, u1 = hyps.shape
    u2 = refs.shape[1]
    dev = hyps.device
    j = torch.arange(u2 + 1, device=dev, dtype=torch.float32)[None]
    row = j.expand(b, u2 + 1)
    # lengths past the padding read the last row / column, as the JAX
    # op's table index clamps
    r_idx = torch.clamp(r_len.long(), 0, u2)[:, None]
    h_len = torch.clamp(h_len.long(), 0, u1)
    dist = torch.gather(row, 1, r_idx)[:, 0]              # h_len == 0
    for i in range(1, u1 + 1):
        cost = (hyps[:, i - 1, None] != refs).to(torch.float32)
        cand = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)
        cand = torch.cat([torch.full_like(row[:, :1], float(i)), cand], 1)
        row = j + torch.cummin(cand - j, dim=1).values
        dist = torch.where(h_len == i, torch.gather(row, 1, r_idx)[:, 0],
                           dist)
    return dist


def _edit_distance_infer(op, block):
    h = in_var(op, block, "Hyps")
    set_output(op, block, "Out", (h.shape[0], 1), "float32")
    set_output(op, block, "SequenceNum", (1,), "int64")


def _edit_distance_compute(ins, attrs, ctx, op_index):
    hyps, refs = ins["Hyps"][0], ins["Refs"][0]
    if hyps.dim() == 3:
        hyps = hyps[:, :, 0]
    if refs.dim() == 3:
        refs = refs[:, :, 0]
    r_len = ins["RefsLength"][0]
    d = edit_distances(hyps, ins["HypsLength"][0], refs, r_len)
    if attrs.get("normalized", True):
        d = d / torch.clamp_min(r_len, 1).to(d.dtype)
    n = torch.full((1,), hyps.shape[0], dtype=torch.int64,
                   device=hyps.device)
    return {"Out": d[:, None], "SequenceNum": n}


register_op("edit_distance", ["Hyps", "HypsLength", "Refs", "RefsLength"],
            ["Out", "SequenceNum"], infer=_edit_distance_infer,
            compute=_edit_distance_compute, grad=None)
