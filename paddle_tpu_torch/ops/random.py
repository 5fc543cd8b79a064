"""``dropout`` and its grad ``dropout_mask_grad`` (counterpart of
``paddle_tpu/ops/random.py``).

The keep mask is drawn from the run's ``ComputeContext.generator``, the
executor's generator for the program's seed (Philox on a CUDA device, the
CPU generator on the host; a CUDA graph of the step registers it, so each
replay draws as the eager run would), so its bits differ from
``jax.random.bernoulli``'s for the same program seed:
the two packages agree on the distribution (each element kept with
probability 1 - p), not on which elements.  The grad reads the saved
``Mask`` output instead of recomputing the forward, which would re-draw.
Semantics as the reference's ``dropout_implementation``:
``downgrade_in_infer`` masks without upscaling in training and scales by
(1 - p) at test time; ``upscale_in_train`` divides kept values by 1 - p.
"""

import torch

from ..framework import grad_var_name
from ..registry import in_var, register_op, set_output


def _dropout_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "Out", x.shape, x.dtype)
    set_output(op, block, "Mask", x.shape, x.dtype)


def _dropout_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        scale = 1.0 if impl == "upscale_in_train" else 1.0 - p
        return {"Out": x * scale, "Mask": torch.ones_like(x)}
    u = torch.rand(x.shape, generator=ctx.generator,
                   device=x.device)
    mask = (u >= p).to(x.dtype)
    if impl == "upscale_in_train":
        mask = mask / max(1.0 - p, 1e-8)
    return {"Out": x * mask, "Mask": mask}


def _dropout_grad_maker(op, no_grad_set):
    x = op.inputs["X"][0]
    if x in no_grad_set:
        return []
    return [dict(
        type="dropout_mask_grad",
        inputs={"Mask": [op.outputs["Mask"][0]],
                "GRAD::Out": [grad_var_name(op.outputs["Out"][0])]},
        outputs={"GRAD::X": [grad_var_name(x)]},
        attrs={})]


register_op("dropout", ["X"], ["Out", "Mask"], infer=_dropout_infer,
            compute=_dropout_compute, grad=_dropout_grad_maker,
            stateful_random=True)


def _dropout_mask_grad_infer(op, block):
    m = in_var(op, block, "Mask")
    set_output(op, block, "GRAD::X", m.shape, m.dtype)


register_op(
    "dropout_mask_grad", ["Mask", "GRAD::Out"], ["GRAD::X"],
    infer=_dropout_mask_grad_infer,
    compute=lambda ins, attrs, ctx, op_index: {
        "GRAD::X": ins["GRAD::Out"][0] * ins["Mask"][0]},
    grad=None)
