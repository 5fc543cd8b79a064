"""``dropout`` and its grad ``dropout_mask_grad``, ``sampling_id`` and
``random_crop`` (counterpart of ``paddle_tpu/ops/random.py``).

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

``sampling_id`` draws one id a row of the probabilities X [batch, n] by
the Gumbel-max rule ``jax.random.categorical`` uses (argmax of log p plus
Gumbel noise from uniform draws, p floored at 1e-20); ``random_crop``
draws each instance's window offsets uniformly in [0, dim - size] and
echoes ``Seed`` as ``SeedOut``.  Both draw from the same generator as
dropout, on the device, so a replay of a captured step draws anew, and
they agree with the JAX ops in distribution, not in their numbers.
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


def _sampling_id_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    u = torch.rand(x.shape, generator=ctx.generator, device=x.device,
                   dtype=x.dtype)
    # Gumbel noise -log(-log u); u = 0 gives -inf, never the argmax
    gumbel = -torch.log(-torch.log(u))
    logits = torch.log(torch.clamp_min(x, 1e-20))
    return {"Out": torch.argmax(logits + gumbel, dim=-1)}


register_op(
    "sampling_id", ["X"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", (in_var(op, block, "X").shape[0],), "int64"),
    compute=_sampling_id_compute, grad=None, stateful_random=True)


def _random_crop_infer(op, block):
    x = in_var(op, block, "X")
    shape = tuple(op.attrs["shape"])
    set_output(op, block, "Out",
               tuple(x.shape[:len(x.shape) - len(shape)]) + shape, x.dtype)
    seed = in_var(op, block, "Seed")
    if seed is not None:
        set_output(op, block, "SeedOut", seed.shape, seed.dtype)


def _random_crop_compute(ins, attrs, ctx, op_index):
    """The trailing ``len(shape)`` dims of each instance cropped to
    ``shape`` at uniform offsets; the offsets stay on the device."""
    x = ins["X"][0]
    crop = tuple(attrs["shape"])
    lead = x.dim() - len(crop)
    flat = x.reshape((-1,) + tuple(x.shape[lead:]))
    n = flat.shape[0]
    idx = [torch.arange(n, device=x.device).reshape(
        (n,) + (1,) * len(crop))]
    for d, size in enumerate(crop):
        off = torch.randint(0, flat.shape[d + 1] - size + 1, (n,),
                            generator=ctx.generator, device=x.device)
        view = [n] + [1] * len(crop)
        view[d + 1] = size
        idx.append((off[:, None] + torch.arange(size, device=x.device))
                   .reshape(view))
    res = {"Out": flat[tuple(idx)].reshape(tuple(x.shape[:lead]) + crop)}
    seed = ins.get("Seed", [None])[0]
    if seed is not None:
        res["SeedOut"] = seed
    return res


register_op("random_crop", ["X", "Seed"], ["Out", "SeedOut"],
            infer=_random_crop_infer, compute=_random_crop_compute,
            grad=None, stateful_random=True, no_grad_inputs=("Seed",))
