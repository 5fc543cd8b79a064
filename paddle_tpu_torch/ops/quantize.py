"""Fake quantization ops (QAT) and real int8 execution (counterpart of
``paddle_tpu/ops/quantize.py``).

The fake-quant ops quantize and dequantize in one op: the tensor stays
float but carries the int8 grid's rounding error.  Their gradient is the
straight-through estimator (an ``ste_identity_grad`` op passing the output
gradient through), and the ``quantize_inference`` pass reads the scales
they trained.  They are plain elementwise PyTorch, not kernels.

``dequant_matmul`` is the op the pass rewrites matmul/mul weights into:
int8 weights with per-output-channel dequant scales, in ``weight_only`` or
``dynamic`` mode (see ``ops/cuda/quant_matmul.py``).  For tensors on the
card it launches kernel #7 for every shape, both modes and a static
``XScale``; for tensors on the CPU it runs the plain version.  There is no
flag and no autotune ruling between the two.
"""

import torch

from ..framework import grad_var_name
from ..registry import in_var, register_op, set_output
from .cuda import quant_matmul as qm
from .math import _flatten_to_2d


def _abs_max_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)
    axis = op.attrs.get("quant_axis", -1)
    scale_shape = (x.shape[axis],) if axis is not None and axis >= 0 \
        else (1,)
    set_output(op, block, "OutScale", scale_shape, x.dtype)


def _abs_max_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    rng = qm.quant_range(attrs.get("bit_length", 8))
    axis = attrs.get("quant_axis", -1)
    if axis is not None and axis >= 0:
        # per-channel grid along ``axis``: one abs-max per channel
        red = tuple(i for i in range(x.dim()) if i != axis)
        # (amax over dim=() would reduce every dim; jnp.max reduces none)
        scale = torch.clamp(x.abs().amax(dim=red) if red else x.abs(),
                            min=1e-12)
        bshape = [1] * x.dim()
        bshape[axis] = scale.shape[0]
        sb = scale.reshape(bshape)
        q = torch.clamp(torch.round(x / sb * rng), -rng, rng)
        return {"Out": q * sb / rng, "OutScale": scale}
    scale = torch.clamp(x.abs().amax().reshape(1), min=1e-12)
    q = torch.clamp(torch.round(x / scale * rng), -rng, rng)
    return {"Out": q * scale / rng, "OutScale": scale}


def _ste_grad_infer(op, block):
    g = in_var(op, block, "GRAD::Out")
    set_output(op, block, "GRAD::X", g.shape, g.dtype)


register_op(
    "ste_identity_grad", ["GRAD::Out"], ["GRAD::X"],
    infer=_ste_grad_infer,
    compute=lambda ins, attrs, ctx, op_index: {
        "GRAD::X": ins["GRAD::Out"][0]},
    grad=None,
)


def _quant_grad_maker(op, no_grad_set):
    """Straight-through estimator: dL/dX = dL/dOut."""
    x_name = op.inputs["X"][0]
    if x_name in no_grad_set:
        return []
    out_name = op.outputs["Out"][0]
    return [{
        "type": "ste_identity_grad",
        "inputs": {"GRAD::Out": [grad_var_name(out_name)]},
        "outputs": {"GRAD::X": [grad_var_name(x_name)]},
        "attrs": {},
    }]


register_op(
    "fake_quantize_abs_max", ["X"], ["Out", "OutScale"],
    infer=_abs_max_infer, compute=_abs_max_compute,
    grad=_quant_grad_maker,
)


def _range_abs_max_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)
    set_output(op, block, "OutScale", (1,), x.dtype)


def _range_abs_max_compute(ins, attrs, ctx, op_index):
    """Running-max variant: in training the scale is max(current |x| max,
    InScale); in test mode InScale is used as it is."""
    x = ins["X"][0]
    in_scales = ins.get("InScale")
    in_scale = in_scales[0] if in_scales and in_scales[0] is not None \
        else torch.zeros((1,), dtype=x.dtype, device=x.device)
    in_scale = in_scale.reshape(1).to(x.dtype)
    rng = qm.quant_range(attrs.get("bit_length", 8))
    if attrs.get("is_test", False):
        scale = torch.clamp(in_scale, min=1e-12)
    else:
        cur = x.abs().amax().reshape(1)
        scale = torch.clamp(torch.maximum(cur, in_scale), min=1e-12)
    q = torch.clamp(torch.round(x / scale * rng), -rng, rng)
    return {"Out": q * scale / rng, "OutScale": scale}


register_op(
    "fake_quantize_range_abs_max", ["X", "InScale"], ["Out", "OutScale"],
    infer=_range_abs_max_infer, compute=_range_abs_max_compute,
    grad=_quant_grad_maker, no_grad_inputs=("InScale",),
)


def _dequant_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)


def _dequant_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    scale = ins["Scale"][0]
    # a 0-dim tensor promotes like a Python number in torch (bfloat16 x
    # float32 0-dim gives bfloat16) but not in jnp: promote explicitly
    dt = torch.promote_types(x.dtype, scale.dtype)
    return {"Out": x.to(dt) * scale.to(dt).reshape(())
            / float(attrs["max_range"])}


register_op(
    "fake_dequantize_max_abs", ["X", "Scale"], ["Out"],
    infer=_dequant_infer, compute=_dequant_compute,
    no_grad_inputs=("Scale",),
)


# ---------------------------------------------------------------------------
# real int8 execution: fused dequant-matmul (kernel #7)
# ---------------------------------------------------------------------------

def _dequant_matmul_infer(op, block):
    x = in_var(op, block, "X")
    qw = in_var(op, block, "QWeight")
    xnc = op.attrs.get("x_num_col_dims", 1)
    out_shape = tuple(x.shape[:xnc]) + (qw.shape[-1],)
    set_output(op, block, "Out", out_shape, x.dtype)


def _dequant_matmul_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    qw = ins["QWeight"][0]
    scale = ins["Scale"][0]
    xscales = ins.get("XScale")
    xscale = xscales[0] if xscales else None
    xnc = attrs.get("x_num_col_dims", 1)
    x2 = _flatten_to_2d(x, xnc).contiguous()
    acc = qm.dequant_matmul(x2, qw, scale,
                            mode=attrs.get("mode", "weight_only"),
                            xscale=xscale,
                            bit_length=attrs.get("bit_length", 8))
    n = qw.shape[-1]
    return {"Out": acc.to(x.dtype).reshape(tuple(x.shape[:xnc]) + (n,))}


register_op(
    "dequant_matmul", ["X", "QWeight", "Scale", "XScale"], ["Out"],
    infer=_dequant_matmul_infer, compute=_dequant_matmul_compute,
    grad=None, no_grad_inputs=("QWeight", "Scale", "XScale"),
)
