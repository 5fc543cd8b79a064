"""Creation ops (counterpart of ``paddle_tpu/ops/creation.py``): the
startup program's init ops ``fill_constant``, ``uniform_random``,
``gaussian_random``, ``truncated_gaussian_random`` and ``assign_value``,
plus ``fill_constant_batch_size_like``, ``assign``, ``cast``, the step
counter's ``increment``, ``fill_zeros_like``, ``shape``,
``uniform_random_batch_size_like``, ``gaussian_random_batch_size_like``,
and ``print`` with its grad op ``print_grad``.  Random ops draw from
``ComputeContext.generator``, the executor's explicit ``torch.Generator``
for the program's seed on the run's device, so their numbers differ from
the JAX package's (``jax.random``) for the same seed: the two agree on
the distribution.

``print`` writes its input to standard output on every run, as the JAX
op's ``jax.debug.print`` does, so it reads the tensor on the host.  A
CUDA graph cannot call the host, so an executor entry that holds a live
``print`` op (or a ``print_grad`` whose phase prints) runs eagerly on
every run and is never captured (``OpDef.calls_host``); its kernels then
launch from the host each run, and the launch counts see them."""

import numpy as np
import torch

from ..core import convert_dtype, dtype_name
from ..framework import grad_var_name
from ..registry import in_var, register_op, same_shape_infer, set_output

_CONSTANTS = {}


def device_constant(array, device):
    """A tensor of the numpy ``array`` on ``device``, which the caller may
    change.  A CUDA copy is made at the first call and kept: a copy from
    the host cannot go into a CUDA graph, and the executor runs each
    entry eagerly before it captures it, so a capture finds the copy here
    and records only a device-to-device clone."""
    array = np.ascontiguousarray(array)
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(array.copy())
    key = (str(device), array.dtype.str, array.shape, array.tobytes())
    held = _CONSTANTS.get(key)
    if held is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a constant of shape %s is first needed inside a CUDA graph "
                "capture; the entry's eager run should have made it"
                % (array.shape,))
        held = _CONSTANTS[key] = torch.from_numpy(array).to(device)
    return held.clone()


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
    # the attr's values: a constant of the op, copied to the card once
    vals = np.asarray(attrs["values"], dtype=attrs.get("dtype", "float32"))
    return {"Out": device_constant(vals.reshape(tuple(attrs["shape"])),
                                   ctx.device)}


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


register_op("fill_zeros_like", ["X"], ["Out"],
            infer=same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, op_index: {
                "Out": torch.zeros_like(ins["X"][0])},
            grad=None)

register_op(
    "shape", ["Input"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", (len(in_var(op, block, "Input").shape),), "int64"),
    # the shape is a constant of the entry (its feeds' shapes key it)
    compute=lambda ins, attrs, ctx, op_index: {"Out": device_constant(
        np.asarray(ins["Input"][0].shape, dtype=np.int64),
        ins["Input"][0].device)},
    grad=None)


def _bsl_shape(ins, attrs):
    """The ``*_batch_size_like`` shape: ``shape`` with dim
    ``output_dim_idx`` taken from the input's dim ``input_dim_idx``."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return tuple(shape)


def _uniform_bsl_compute(ins, attrs, ctx, op_index):
    out = torch.empty(_bsl_shape(ins, attrs), dtype=_dtype(attrs),
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator)
    return {"Out": out}


def _gaussian_bsl_compute(ins, attrs, ctx, op_index):
    out = torch.empty(_bsl_shape(ins, attrs), dtype=_dtype(attrs),
                      device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator)
    return {"Out": out}


for _type, _compute in (("uniform_random_batch_size_like",
                         _uniform_bsl_compute),
                        ("gaussian_random_batch_size_like",
                         _gaussian_bsl_compute)):
    register_op(_type, ["Input"], ["Out"], infer=_shape_infer,
                compute=_compute, grad=None, stateful_random=True)


def _prints_forward(attrs):
    return attrs.get("print_phase", "FORWARD") in ("FORWARD", "BOTH")


def _prints_backward(attrs):
    return attrs.get("print_phase") in ("BACKWARD", "BOTH")


def _print_tensor(x, attrs, name):
    """One line as the JAX op prints it: the message, the name, shape,
    dtype (each as its attrs ask) and the value."""
    parts = [str(attrs["message"])] if attrs.get("message") else []
    if attrs.get("print_tensor_name", True):
        parts.append(name)
    if attrs.get("print_tensor_shape", True):
        parts.append("shape=%s" % (tuple(x.shape),))
    if attrs.get("print_tensor_type", True):
        parts.append("dtype=%s" % dtype_name(x.dtype))
    value = x.detach()
    if value.dtype == torch.bfloat16:
        value = value.float()
    parts.append("value=%s" % value.cpu().numpy())
    print(" ".join(parts), flush=True)


def _print_compute(ins, attrs, ctx, op_index):
    x = ins["In"][0]
    if _prints_forward(attrs):
        _print_tensor(x, attrs, attrs.get("__var_name__", ""))
    return {"Out": x}


def _print_grad_maker(op, no_grad_set):
    # the cotangent passes straight through (a recompute would print the
    # forward again) and is printed where the phase asks
    x = op.inputs["In"][0]
    if x in no_grad_set:
        return []
    g_out = grad_var_name(op.outputs["Out"][0])
    attrs = dict(op.attrs)
    attrs["__grad_name__"] = g_out
    return [dict(type="print_grad", inputs={"GRAD::Out": [g_out]},
                 outputs={"GRAD::In": [grad_var_name(x)]}, attrs=attrs)]


def _print_grad_compute(ins, attrs, ctx, op_index):
    g = ins["GRAD::Out"][0]
    if _prints_backward(attrs):
        _print_tensor(g, attrs, attrs.get("__grad_name__", ""))
    return {"GRAD::In": g}


def _print_grad_infer(op, block):
    g = in_var(op, block, "GRAD::Out")
    set_output(op, block, "GRAD::In", g.shape, g.dtype)


register_op("print", ["In"], ["Out"], infer=same_shape_infer("In", "Out"),
            compute=_print_compute, grad=_print_grad_maker,
            calls_host=_prints_forward)
register_op("print_grad", ["GRAD::Out"], ["GRAD::In"],
            infer=_print_grad_infer, compute=_print_grad_compute, grad=None,
            calls_host=_prints_backward)
