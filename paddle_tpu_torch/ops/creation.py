"""Creation ops (counterpart of ``paddle_tpu/ops/creation.py``): the
startup program's init ops ``fill_constant``, ``uniform_random``,
``gaussian_random``, ``truncated_gaussian_random`` and ``assign_value``,
plus ``fill_constant_batch_size_like``, ``assign``, ``cast`` and the step
counter's ``increment``.  Random
ops draw from ``ComputeContext.generator``, the executor's explicit
``torch.Generator`` for the program's seed on the run's device."""

import numpy as np
import torch

from ..core import convert_dtype
from ..registry import in_var, register_op, same_shape_infer, set_output


def _dtype(attrs):
    return convert_dtype(attrs.get("dtype", "float32"))


def _shape_infer(op, block):
    set_output(op, block, "Out", op.attrs["shape"], _dtype(op.attrs))


def _fill_constant_compute(ins, attrs, ctx, op_index):
    return {"Out": torch.full(tuple(attrs["shape"]), attrs.get("value", 0.0),
                              dtype=_dtype(attrs), device=ctx.device)}


def _uniform_random_compute(ins, attrs, ctx, op_index):
    out = torch.empty(tuple(attrs["shape"]), dtype=_dtype(attrs),
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator)
    return {"Out": out}


def _gaussian_random_compute(ins, attrs, ctx, op_index):
    out = torch.empty(tuple(attrs["shape"]), dtype=_dtype(attrs),
                      device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator)
    return {"Out": out}


def _truncated_gaussian_compute(ins, attrs, ctx, op_index):
    # truncated to +-2 std, like the JAX package and the reference op
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    out = torch.empty(tuple(attrs["shape"]), dtype=_dtype(attrs),
                      device=ctx.device)
    torch.nn.init.trunc_normal_(out, mean, std, mean - 2.0 * std,
                                mean + 2.0 * std,
                                generator=ctx.generator)
    return {"Out": out}


for _type, _compute in (("fill_constant", _fill_constant_compute),
                        ("uniform_random", _uniform_random_compute),
                        ("gaussian_random", _gaussian_random_compute),
                        ("truncated_gaussian_random",
                         _truncated_gaussian_compute)):
    register_op(_type, [], ["Out"], infer=_shape_infer, compute=_compute,
                grad=None, stateful_random=_type != "fill_constant")


def _fcbsl_compute(ins, attrs, ctx, op_index):
    """``fill_constant`` of ``shape`` with dim ``output_dim_idx`` taken
    from the input's dim ``input_dim_idx`` (its batch size)."""
    x = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        x.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=_dtype(attrs), device=x.device)}


register_op("fill_constant_batch_size_like", ["Input"], ["Out"],
            infer=_shape_infer, compute=_fcbsl_compute, grad=None)


def _assign_value_compute(ins, attrs, ctx, op_index):
    vals = np.asarray(attrs["values"], dtype=attrs.get("dtype", "float32"))
    return {"Out": torch.from_numpy(vals.reshape(tuple(attrs["shape"])))
            .to(ctx.device)}


register_op("assign_value", [], ["Out"], infer=_shape_infer,
            compute=_assign_value_compute, grad=None)

register_op("assign", ["X"], ["Out"], infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {"Out": ins["X"][0]})


def _cast_infer(op, block):
    set_output(op, block, "Out", in_var(op, block, "X").shape,
               op.attrs["out_dtype"])


register_op("cast", ["X"], ["Out"], infer=_cast_infer,
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": ins["X"][0].to(convert_dtype(attrs["out_dtype"]))})


def _increment_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    # the counter keeps its dtype (float32 for the LR schedules); a 0-dim
    # host tensor is a scalar operand, so no host-to-device copy waits
    return {"Out": x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype)}


register_op(
    "increment", ["X"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "X").shape,
        in_var(op, block, "X").dtype),
    compute=_increment_compute, grad=None)
