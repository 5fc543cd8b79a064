"""``linear_chain_crf``, ``crf_decoding`` and ``chunk_eval`` over padded
sequence batches (counterpart of ``paddle_tpu/ops/crf.py``).

Sequences are ``[B, T, D]`` padded batches with ``[B]`` lengths.  Each
recursion is a loop of T - 1 trips over the whole batch, never a loop per
sequence:

* ``linear_chain_crf``: the negative log-likelihood of the gold path under
  a ``[D+2, D]`` transition (row 0 the start weights, row 1 the end
  weights, rows 2.. tag -> tag), with the log partition from the
  log-space forward recursion (a ``logsumexp`` over the previous tag a
  trip; a step past a sequence's length keeps its alphas).  The gradient
  is autograd through that recursion, as the JAX op's is ``jax.vjp``'s.
* ``crf_decoding``: Viterbi; the best predecessor of each tag is the
  first maximum (``torch.max``'s index, ``jnp.argmax``'s rule), and a
  step past the length points each tag at itself, so the backtrack walks
  through the padding unchanged.  With a ``Label`` the output is the
  per-position correctness mask.
* ``chunk_eval``: the reference's chunk state machine as per-position
  begin / end flags; where a chunk closes is the reverse cumulative
  minimum of the end positions (the JAX op's reverse scan).  The counts
  stay int64 device tensors.
"""

import torch

from ..registry import in_var, optional, register_op, set_output
from .sequence import _time_mask


def _labels(label):
    return (label[:, :, 0] if label.dim() == 3 else label).long()


# -- linear_chain_crf -------------------------------------------------------

def crf_nll(emission, length, transition, label):
    """[B] negative log-likelihoods of ``label``'s paths."""
    t = emission.shape[1]
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    valid = _time_mask(length, t, 0)                     # [B, T]
    alpha = start_w[None] + emission[:, 0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, i]
        alpha = torch.where(valid[:, i, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + end_w[None], dim=1)

    lbl = _labels(label)
    emit = torch.gather(emission, 2, lbl[:, :, None])[:, :, 0]
    emit_score = torch.where(valid, emit, 0.0).sum(dim=1)
    pair = trans[lbl[:, :-1], lbl[:, 1:]]                 # [B, T-1]
    trans_score = torch.where(valid[:, 1:], pair, 0.0).sum(dim=1)
    last = torch.clamp_min(length.long() - 1, 0)
    last_tag = torch.gather(lbl, 1, last[:, None])[:, 0]
    score = start_w[lbl[:, 0]] + emit_score + trans_score + end_w[last_tag]
    return log_z - score


def _crf_infer(op, block):
    e = in_var(op, block, "Emission")
    set_output(op, block, "LogLikelihood", (e.shape[0], 1), e.dtype)


def _crf_compute(ins, attrs, ctx, op_index):
    nll = crf_nll(ins["Emission"][0], ins["Length"][0],
                  ins["Transition"][0], ins["Label"][0])
    return {"LogLikelihood": nll[:, None]}


register_op("linear_chain_crf", ["Emission", "Length", "Transition", "Label"],
            ["LogLikelihood"], infer=_crf_infer, compute=_crf_compute,
            no_grad_inputs=("Length", "Label"))


# -- crf_decoding -----------------------------------------------------------

def viterbi(emission, length, transition):
    """([B, T] int64 best paths, zeros past each length; [B, T] valid)."""
    b, t, d = emission.shape
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    valid = _time_mask(length, t, 0)
    same = torch.arange(d, device=emission.device)[None].expand(b, d)
    v = start_w[None] + emission[:, 0]
    bps = []
    for i in range(1, t):
        best, prev = torch.max(v[:, :, None] + trans[None], dim=1)
        ok = valid[:, i, None]
        v = torch.where(ok, best + emission[:, i], v)
        bps.append(torch.where(ok, prev, same))
    tag = torch.argmax(v + end_w[None], dim=1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    return torch.where(valid, path, 0), valid


def _crf_decoding_infer(op, block):
    e = in_var(op, block, "Emission")
    set_output(op, block, "ViterbiPath", (e.shape[0], e.shape[1], 1),
               "int64", lod_level=1)


def _crf_decoding_compute(ins, attrs, ctx, op_index):
    path, valid = viterbi(ins["Emission"][0], ins["Length"][0],
                          ins["Transition"][0])
    label = optional(ins, "Label")
    if label is not None:
        # with a Label: the per-position correctness mask
        path = torch.where(valid, (path == _labels(label)).long(), 0)
    return {"ViterbiPath": path[:, :, None]}


register_op("crf_decoding", ["Emission", "Length", "Transition", "Label"],
            ["ViterbiPath"], infer=_crf_decoding_infer,
            compute=_crf_decoding_compute, grad=None)


# -- chunk_eval -------------------------------------------------------------

# scheme -> (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_end(prev_tag, prev_type, tag, typ, other, tb, ti, te, ts):
    """Does the chunk open at ``prev`` close there, given the next tag?
    The reference's clauses, the first that matches deciding."""
    r = torch.zeros_like(tag, dtype=torch.bool)
    r = torch.where(prev_tag == ts, True, r)
    r = torch.where(prev_tag == te, True, r)
    r = torch.where(prev_tag == ti, (tag == tb) | (tag == ts), r)
    r = torch.where(prev_tag == tb, (tag == tb) | (tag == ts), r)
    r = torch.where(typ != prev_type, True, r)
    r = torch.where(typ == other, True, r)
    return torch.where(prev_type == other, False, r)


def _chunk_begin(prev_tag, prev_type, tag, typ, other, tb, ti, te, ts):
    r = torch.zeros_like(tag, dtype=torch.bool)
    r = torch.where(tag == ts, True, r)
    r = torch.where(tag == te, (prev_tag == te) | (prev_tag == ts), r)
    r = torch.where(tag == ti, (prev_tag == te) | (prev_tag == ts), r)
    r = torch.where(tag == tb, True, r)
    r = torch.where(typ != prev_type, True, r)
    r = torch.where(typ == other, False, r)
    return torch.where(prev_type == other, typ != other, r)


def _shift(x, fill, forward):
    """``x`` [B, T] moved one step along time (``forward``: x[t-1] at t),
    ``fill`` entering at the open end."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([pad, x[:, :-1]], 1) if forward else \
        torch.cat([x[:, 1:], pad], 1)


def _chunk_flags(tags, types, scheme, other):
    """(begin, end_at) [B, T]: a chunk starts where ChunkBegin(prev, cur)
    fires and closes at i where ChunkEnd(i, i + 1) fires; a virtual
    (-1, other) precedes the first step and follows the last."""
    _, tb, ti, te, ts = _SCHEMES[scheme]
    begin = _chunk_begin(_shift(tags, -1, True), _shift(types, other, True),
                         tags, types, other, tb, ti, te, ts)
    end_at = _chunk_end(tags, types, _shift(tags, -1, False),
                        _shift(types, other, False), other, tb, ti, te, ts)
    return begin, end_at


def _first_end(end_at):
    """[B, T]: the first position at or after each where a chunk closes
    (T where none does)."""
    t = end_at.shape[1]
    pos = torch.where(end_at, torch.arange(t, device=end_at.device), t)
    return torch.flip(torch.cummin(torch.flip(pos, [1]), dim=1).values, [1])


def chunk_counts(inference, label, length, num_chunk_types, scheme="IOB",
                 excluded=()):
    """(inferred, labelled, correct) chunk counts, int64 [1] each."""
    num_tag_types = _SCHEMES[scheme][0]
    other = num_chunk_types
    t = inference.shape[1]
    valid = _time_mask(length, t, 0)

    def decomp(x):
        x = x.long()
        tag = x % num_tag_types
        typ = torch.where(x >= num_tag_types * num_chunk_types, other,
                          x // num_tag_types)
        return tag, torch.where(valid, typ, other)

    itag, ityp = decomp(_labels(inference))
    ltag, ltyp = decomp(_labels(label))
    ib, ie_at = _chunk_flags(itag, ityp, scheme, other)
    lb, le_at = _chunk_flags(ltag, ltyp, scheme, other)
    for ex in excluded:
        ib = ib & (ityp != ex)
        lb = lb & (ltyp != ex)
    n_inf = (ib & valid).sum().reshape(1)
    n_lab = (lb & valid).sum().reshape(1)
    correct = ib & lb & valid & (ityp == ltyp) & \
        (_first_end(ie_at) == _first_end(le_at))
    return n_inf, n_lab, correct.sum().reshape(1)


def _chunk_eval_compute(ins, attrs, ctx, op_index):
    n_inf, n_lab, n_cor = chunk_counts(
        ins["Inference"][0], ins["Label"][0], ins["Length"][0],
        int(attrs["num_chunk_types"]), attrs.get("chunk_scheme", "IOB"),
        list(attrs.get("excluded_chunk_types", []) or []))
    f, l, c = (x.to(torch.float32) for x in (n_inf, n_lab, n_cor))
    precision = torch.where(f > 0, c / torch.clamp_min(f, 1), 0.0)
    recall = torch.where(l > 0, c / torch.clamp_min(l, 1), 0.0)
    s = precision + recall
    f1 = torch.where(s > 0, 2 * precision * recall / torch.clamp_min(
        s, 1e-12), 0.0)
    return {"Precision": precision, "Recall": recall, "F1-Score": f1,
            "NumInferChunks": n_inf, "NumLabelChunks": n_lab,
            "NumCorrectChunks": n_cor}


def _chunk_eval_infer(op, block):
    for slot in ("Precision", "Recall", "F1-Score"):
        set_output(op, block, slot, (1,), "float32")
    for slot in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        set_output(op, block, slot, (1,), "int64")


register_op("chunk_eval", ["Inference", "Label", "Length"],
            ["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"],
            infer=_chunk_eval_infer, compute=_chunk_eval_compute, grad=None)
