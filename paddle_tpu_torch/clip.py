"""Gradient clipping hooks of the optimizer (counterpart of
``paddle_tpu/clip.py``), on the path with no clip: the clip classes
(``GradientClipByValue``, ``...ByNorm``, ``...ByGlobalNorm``,
``ErrorClipByValue``) and their ops are not ported yet, so a parameter or
variable that asks for one raises instead of training unclipped."""

__all__ = ["append_gradient_clip_ops", "error_clip_callback"]


def _not_ported(what):
    return NotImplementedError(
        "%s: gradient clipping is not ported to paddle_tpu_torch yet "
        "(ROADMAP Queue A)" % what)


def error_clip_callback(block, op):
    """Raise if a forward var of one of ``op``'s gradients carries an
    ``error_clip``."""
    for grad_n in op.output_arg_names:
        if not grad_n.endswith("@GRAD"):
            continue
        fwd_var = block._find_var_recursive(grad_n[:-len("@GRAD")])
        if getattr(fwd_var, "error_clip", None) is not None:
            raise _not_ported("error_clip on %r" % fwd_var.name)


def append_gradient_clip_ops(param_grads):
    """The (param, grad) pairs unchanged: no parameter may set a gradient
    clip (``ParamAttr(gradient_clip=...)``)."""
    for p, g in param_grads:
        if g is not None and p.gradient_clip_attr is not None:
            raise _not_ported("gradient clip on %r" % p.name)
    return list(param_grads)
