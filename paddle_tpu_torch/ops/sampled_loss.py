"""``nce``, ``hierarchical_sigmoid`` and ``bilinear_tensor_product``
(counterpart of ``paddle_tpu/ops/sampled_loss.py``).

``nce`` draws its ``num_neg_samples`` uniform negatives a row from the
run's ``ComputeContext.generator`` (on the device, so a captured step
draws anew on every replay), so its samples differ from the JAX op's
(``jax.random.randint`` of the step's key): the two agree on the formula
over the samples and on their distribution, not on which classes are
drawn.  It is ``keep_graph``: its gradient pulls back through the
forward's own graph, so it belongs to the samples the cost was computed
on; a recompute would draw new ones.

``hierarchical_sigmoid`` walks the SimpleCode tree in integer arithmetic
(the code's bit length from shifts, never a float ``log2``).  Rows of the
weight tables are gathered with ``_Gather``, whose backward adds each
row's gradients in a fixed order.  Both losses use ``log_add_exp`` for
``jax.nn.softplus``'s arithmetic.
"""

import math

import torch

from ..registry import in_var, optional, register_op, set_output
from .ctc import log_add_exp
from .manipulation import _Gather


def _rows(w, idx):
    """``w[idx]`` for an integer tensor ``idx`` of any shape."""
    return _Gather.apply(w, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(w.shape[1:]))


# -- nce --------------------------------------------------------------------

def _nce_infer(op, block):
    x = in_var(op, block, "Input")
    label = in_var(op, block, "Label")
    num_true = label.shape[1] if len(label.shape) > 1 and \
        label.shape[1] not in (-1, None) else 1
    s = num_true + int(op.attrs.get("num_neg_samples", 10))
    set_output(op, block, "Cost", (x.shape[0], 1), x.dtype)
    set_output(op, block, "SampleLogits", (x.shape[0], s), x.dtype)
    set_output(op, block, "SampleLabels", (x.shape[0], s), "int64")


def nce_cost(x, samples, num_true, weight, bias, sample_weight, b_const):
    """(cost [B], sigmoid logits [B, S]) of the samples ``[B, S]`` (the
    true classes first)."""
    logits = torch.bmm(_rows(weight, samples), x[:, :, None])[:, :, 0]
    if bias is not None:
        logits = logits + _rows(bias.reshape(-1, 1), samples)[:, :, 0]
    o = torch.sigmoid(logits)
    eps = 1e-12
    ot, on = o[:, :num_true], o[:, num_true:]
    cost = -torch.log(ot / (ot + b_const) + eps).sum(1) \
        - torch.log(b_const / (on + b_const) + eps).sum(1)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1)
    return cost, o


def _nce_compute(ins, attrs, ctx, op_index):
    x = ins["Input"][0]
    label = ins["Label"][0]
    if label.dim() == 1:
        label = label[:, None]
    num_classes = int(attrs["num_total_classes"])
    num_neg = int(attrs.get("num_neg_samples", 10))
    negs = torch.randint(0, num_classes, (x.shape[0], num_neg),
                         generator=ctx.generator, device=x.device)
    samples = torch.cat([label.long(), negs], dim=1)
    cost, o = nce_cost(x, samples, label.shape[1], ins["Weight"][0],
                       optional(ins, "Bias"), optional(ins, "SampleWeight"),
                       float(num_neg) / num_classes)
    return {"Cost": cost[:, None], "SampleLogits": o,
            "SampleLabels": samples}


register_op("nce", ["Input", "Label", "Weight", "Bias", "SampleWeight"],
            ["Cost", "SampleLogits", "SampleLabels"], infer=_nce_infer,
            compute=_nce_compute, no_grad_inputs=("Label", "SampleWeight"),
            stateful_random=True, keep_graph=True)


# -- hierarchical_sigmoid ---------------------------------------------------

def hsigmoid_paths(label, num_classes):
    """(node rows [B, J], target bits [B, J], active [B, J]) of each
    label's SimpleCode path: code c = label + num_classes, bit length
    len = floor(log2 c); node j is row (c >> (len - j)) - 1 with bit
    (c >> (len - 1 - j)) & 1."""
    max_len = int(math.ceil(math.log2(max(num_classes, 2))))
    code = label.reshape(-1).long() + num_classes
    bits = torch.arange(1, 32, device=code.device)
    clen = ((code[:, None] >> bits) > 0).sum(1)
    j = torch.arange(max_len + 1, device=code.device)[None]
    active = j < clen[:, None]
    node = (code[:, None] >> torch.clamp_min(clen[:, None] - j, 0)) - 1
    node = torch.clamp(node, 0, num_classes - 2)
    bit = (code[:, None] >> torch.clamp_min(clen[:, None] - 1 - j, 0)) & 1
    return node, bit, active


def _hsigmoid_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", (x.shape[0], 1), x.dtype)


def _hsigmoid_compute(ins, attrs, ctx, op_index):
    x, w = ins["X"][0], ins["W"][0]
    node, bit, active = hsigmoid_paths(ins["Label"][0],
                                       int(attrs["num_classes"]))
    node = torch.clamp(node, 0, w.shape[0] - 1)
    pre = torch.bmm(_rows(w, node), x[:, :, None])[:, :, 0]
    bias = optional(ins, "Bias")
    if bias is not None:
        pre = pre + _rows(bias.reshape(-1, 1), node)[:, :, 0]
    # BCE with logits against the bit: softplus(pre) - bit * pre
    losses = log_add_exp(pre, 0.0) - bit.to(pre.dtype) * pre
    return {"Out": torch.where(active, losses, 0.0).sum(1)[:, None]}


register_op("hierarchical_sigmoid", ["X", "W", "Label", "Bias"], ["Out"],
            infer=_hsigmoid_infer, compute=_hsigmoid_compute,
            no_grad_inputs=("Label",))


# -- bilinear_tensor_product ------------------------------------------------

def _btp_infer(op, block):
    x = in_var(op, block, "X")
    w = in_var(op, block, "Weight")
    set_output(op, block, "Out", (x.shape[0], w.shape[0]), x.dtype)


def _btp_compute(ins, attrs, ctx, op_index):
    """out[b, k] = x[b] . W[k] . y[b] (+ bias[k])."""
    out = torch.einsum("bi,kij,bj->bk", ins["X"][0], ins["Weight"][0],
                       ins["Y"][0])
    bias = optional(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": out}


register_op("bilinear_tensor_product", ["X", "Y", "Weight", "Bias"], ["Out"],
            infer=_btp_infer, compute=_btp_compute)
