"""The ``recurrent`` op, which runs a sub-block once per time step
(counterpart of the ``recurrent`` op of ``paddle_tpu/ops/control_flow.py``;
``StaticRNN`` and ``DynamicRNN`` build it).

The op carries every external the sub-block reads as an input of its own:
float step inputs (``Inputs``) apart from integer ones (``IntInputs``),
the memories' initial values (``InitStates``), float externals
(``Params``: weights, and activations of the enclosing block such as an
encoder's output) apart from the others (``Consts``), and an optional
[B] ``Length``.  So the executor's liveness and its freeing of
temporaries see the sub-block's reads as the op's, and the generic grad
reaches ``Inputs``, ``InitStates`` and ``Params`` and stops at the rest.

Where the JAX package lowers the loop to ``lax.scan``, the port runs it as
a Python loop over the steps: step t binds each step input's slice t and
the memories' current values, computes the sub-block's ops through
``registry.compute_op`` (so the AMP policy applies inside the loop) in a
context of the step's own (``ComputeContext.sub_context``), casts each
updated memory back to its memory's dtype, and stacks the step outputs.
With a ``Length``, a row whose length is at most t keeps its memories and
emits zeros.  On the card the loop is unrolled into the step's CUDA graph.

The op is ``keep_graph`` (``registry``): its gradient pulls back through
the forward's own autograd graph, so a ``dropout`` in the body gets the
masks the forward drew.
"""

import torch

from .. import registry
from ..registry import in_var, register_op


def _mask_to(valid, like):
    """A [B] bool mask shaped to broadcast against [B, ...] ``like``."""
    return valid.reshape((-1,) + (1,) * (like.dim() - 1))


def _recurrent_infer(op, block):
    sub = block.program.block(op.attrs["sub_block"])
    time_major = op.attrs.get("time_major", True)
    x0 = in_var(op, block, "Inputs") or in_var(op, block, "IntInputs")
    t = x0.shape[0] if time_major else x0.shape[1]
    for parent_name, blk_name in zip(op.outputs.get("Outputs", []),
                                     op.attrs["output_names"]):
        v = sub._find_var_recursive(blk_name)
        shape = tuple(v.shape or ())
        out_shape = ((t,) + shape if time_major
                     else shape[:1] + (t,) + shape[1:])
        ov = block._find_var_recursive(parent_name) or \
            block.create_var(name=parent_name)
        ov.shape = out_shape
        ov.dtype = v.dtype
    for parent_name, blk_name in zip(op.outputs.get("FinalStates", []),
                                     op.attrs["state_names"]):
        v = sub._find_var_recursive(blk_name)
        ov = block._find_var_recursive(parent_name) or \
            block.create_var(name=parent_name)
        ov.shape = tuple(v.shape or ())
        ov.dtype = v.dtype


def _recurrent_compute(ins, attrs, ctx, op_index):
    sub = ctx.program.block(attrs["sub_block"])
    time_major = attrs.get("time_major", True)
    step_in_names = list(attrs["step_input_names"]) + \
        list(attrs.get("int_step_input_names", []))
    pre_names = attrs["pre_state_names"]
    post_names = attrs["state_names"]
    out_names = attrs["output_names"]

    xs = list(ins.get("Inputs") or []) + list(ins.get("IntInputs") or [])
    carry = list(ins.get("InitStates") or [])
    length = (ins.get("Length") or [None])[0]
    base_env = dict(zip(attrs.get("param_names", []), ins.get("Params", [])))
    base_env.update(zip(attrs.get("const_names", []),
                        ins.get("Consts", [])))

    t_len = xs[0].shape[0 if time_major else 1]
    steps = range(t_len)
    if attrs.get("is_reverse", False):
        steps = reversed(steps)
    stacked = [[None] * t_len for _ in out_names]
    for t in steps:
        env = dict(base_env)
        env.update(zip(step_in_names,
                       (x[t] if time_major else x[:, t] for x in xs)))
        env.update(zip(pre_names, carry))
        step_ctx = ctx.sub_context(op_index, t)
        for i, op in enumerate(sub.ops):
            registry.compute_op(op, env, step_ctx, op_index=i)
        # under AMP a black op in the body can promote a bfloat16 memory
        # to float32: the carry keeps each memory's dtype
        new = [env[n].to(c.dtype) for n, c in zip(post_names, carry)]
        outs = [env[n] for n in out_names]
        if length is not None:
            valid = length > t
            new = [torch.where(_mask_to(valid, v), v, c)
                   for v, c in zip(new, carry)]
            outs = [torch.where(_mask_to(valid, o), o, 0) for o in outs]
        carry = new
        for col, o in zip(stacked, outs):
            col[t] = o
    dim = 0 if time_major else 1
    return {"Outputs": [torch.stack(col, dim=dim) for col in stacked],
            "FinalStates": carry}


register_op(
    "recurrent",
    ["Inputs", "IntInputs", "InitStates", "Params", "Consts", "Length"],
    ["Outputs", "FinalStates"],
    infer=_recurrent_infer, compute=_recurrent_compute,
    no_grad_inputs=("IntInputs", "Consts", "Length"), keep_graph=True)
