"""Gradient and error clipping (counterpart of ``paddle_tpu/clip.py``):
``ErrorClipByValue``, ``GradientClipByValue``, ``GradientClipByNorm`` and
``GradientClipByGlobalNorm``.  Their ops are appended between the backward
and the optimizer ops, per parameter (``ParamAttr(gradient_clip=...)``) or
for a whole program (``set_gradient_clip``).  The clip of a SELECTED_ROWS
gradient is itself SELECTED_ROWS (the ops keep the rows), so the
regularizer and the optimizer that follow keep it sparse."""

from .core import VarType, dtype_name
from .framework import default_main_program
from .layer_helper import LayerHelper

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]


def _propagate_sparse(src, dst):
    """``dst`` takes ``src``'s SELECTED_ROWS type."""
    if getattr(src, "type", None) == VarType.SELECTED_ROWS:
        dst.type = VarType.SELECTED_ROWS
    return dst


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip a variable's backward error signal to [min, max]."""

    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max = float(max)
        self.min = float(min)

    def _append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, op):
    """Append the ``error_clip`` of each forward var whose gradient ``op``
    writes."""
    for grad_n in op.output_arg_names:
        if not grad_n.endswith("@GRAD"):
            continue
        fwd_var = block._find_var_recursive(grad_n[:-len("@GRAD")])
        if fwd_var is None:
            continue
        error_clip = getattr(fwd_var, "error_clip", None)
        if error_clip is not None:
            error_clip._append_clip_op(block, grad_n)


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max = float(max)
        self.min = float(min)

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_grad")
        new_grad = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(type="clip", inputs={"X": [grad]},
                             outputs={"Out": [new_grad]},
                             attrs={"min": self.min, "max": self.max})
        return param, _propagate_sparse(grad, new_grad)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_grad_norm")
        new_grad = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(type="clip_by_norm", inputs={"X": [grad]},
                             outputs={"Out": [new_grad]},
                             attrs={"max_norm": self.clip_norm})
        return param, _propagate_sparse(grad, new_grad)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale every gradient of a group by clip_norm / max(global norm,
    clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError(
                "all parameters in a group should share one clip_norm")
        helper = LayerHelper("global_norm_part")
        sq = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(type="squared_l2_norm", inputs={"X": [grad]},
                             outputs={"Out": [sq]})
        context[self.group_name].append(sq)
        context[self.group_name + "_scale_computed"] = None

    def _create_operators(self, param, grad):
        # the group's scale is computed once, in append_gradient_clip_ops
        raise NotImplementedError(
            "handled by append_gradient_clip_ops group logic")


def set_gradient_clip(clip, param_list=None, program=None):
    """Set the gradient clip of the parameters in ``param_list``, or,
    without one, of every parameter of ``program`` (the default main
    program) that sets none itself."""
    program = program or default_main_program()
    if param_list is not None:
        for p in param_list:
            if isinstance(p, str):
                p = program.global_block().var(p)
            p.gradient_clip_attr = clip
    else:
        program._gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """The (param, grad) pairs after each parameter's clip, or its
    program's."""
    context = {}
    clips = []
    for p, g in param_grads:
        if g is None:
            clips.append((p, g, None))
            continue
        prog_clip = getattr(p.block.program, "_gradient_clip_attr", None)
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            prog_clip or NullGradientClipAttr()
        clip_attr._process_context(context, p, g)
        clips.append((p, g, clip_attr))

    # one scale a global-norm group: clip / max(sqrt(sum of squares), clip)
    group_scales = {}
    for group_name, sq_list in list(context.items()):
        if not isinstance(sq_list, list):
            continue
        clip_value = context[group_name + "_clip_value"]
        helper = LayerHelper("global_norm")
        block = sq_list[0].block
        total = helper.create_variable_for_type_inference(
            dtype=sq_list[0].dtype)
        block.append_op(type="sum", inputs={"X": sq_list},
                        outputs={"Out": [total]})
        norm = helper.create_variable_for_type_inference(dtype=total.dtype)
        block.append_op(type="sqrt", inputs={"X": [total]},
                        outputs={"Out": [norm]})
        maxed = helper.create_variable_for_type_inference(dtype=total.dtype)
        clip_var = helper.create_variable_for_type_inference(
            dtype=total.dtype)
        block.append_op(type="fill_constant", outputs={"Out": [clip_var]},
                        attrs={"shape": [1], "value": clip_value,
                               "dtype": dtype_name(total.dtype)})
        block.append_op(type="elementwise_max",
                        inputs={"X": [norm], "Y": [clip_var]},
                        outputs={"Out": [maxed]})
        scale = helper.create_variable_for_type_inference(dtype=total.dtype)
        block.append_op(type="elementwise_div",
                        inputs={"X": [clip_var], "Y": [maxed]},
                        outputs={"Out": [scale]})
        group_scales[group_name] = scale

    result = []
    for p, g, clip_attr in clips:
        if g is None:
            result.append((p, g))
            continue
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            scale = group_scales[clip_attr.group_name]
            helper = LayerHelper("global_clip_grad")
            new_grad = helper.create_variable_for_type_inference(
                dtype=g.dtype)
            g.block.append_op(type="elementwise_mul",
                              inputs={"X": [g], "Y": [scale]},
                              outputs={"Out": [new_grad]})
            result.append((p, _propagate_sparse(g, new_grad)))
        else:
            result.append(clip_attr._create_operators(p, g))
    return result
