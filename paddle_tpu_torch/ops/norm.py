"""``layer_norm`` (counterpart of the layer_norm op in
``paddle_tpu/ops/norm.py``).  Rows are the dims before ``begin_norm_axis``;
the op flattens x to [rows, D] and calls ``ops.cuda.layer_norm``: kernels
#3 (forward) and #4 (backward) on the card, their plain versions on the
CPU.  Where the JAX package makes
the Pallas kernel opt-in behind ``FLAGS_pallas_kernels``, here the kernel
is the path on the card, with no fallback.  Mean/Variance come out in x's
dtype, computed in float32, and have no gradient: a nonzero cotangent on
them raises in the generic grad."""

import torch

from ..registry import in_var, register_op, set_output
from .cuda import layer_norm as ln


def _ln_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attrs.get("begin_norm_axis", 1)
    rows = x.shape[:axis]
    set_output(op, block, "Y", x.shape, x.dtype)
    set_output(op, block, "Mean", rows, x.dtype)
    set_output(op, block, "Variance", rows, x.dtype)


def _ln_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    axis = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    rows = tuple(x.shape[:axis])
    d = 1
    for s in x.shape[axis:]:
        d *= s
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    scale = (torch.ones(d, dtype=x.dtype, device=x.device) if scale is None
             else scale.reshape(d))
    bias = (torch.zeros(d, dtype=x.dtype, device=x.device) if bias is None
            else bias.reshape(d))
    y, mean, var = ln.layer_norm(x.reshape(-1, d).contiguous(),
                                 scale.contiguous(), bias.contiguous(),
                                 float(eps))
    return {"Y": y.reshape(x.shape), "Mean": mean.reshape(rows).to(x.dtype),
            "Variance": var.reshape(rows).to(x.dtype)}


register_op("layer_norm", ["X", "Scale", "Bias"], ["Y", "Mean", "Variance"],
            infer=_ln_infer, compute=_ln_compute)
