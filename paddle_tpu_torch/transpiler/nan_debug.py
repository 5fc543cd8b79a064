"""Op-by-op replay for NaN provenance (counterpart of
``paddle_tpu/transpiler/nan_debug.py``).

``check_nan_inf`` sees the step's boundary: it names the first
non-finite fetch or written-back variable, not the op that made it.  On
the card the step is one CUDA graph, so nothing in between is visible
either.  This module walks the program again, op by op, on the place the
executor ran it on, tests each op's floating outputs with ``isfinite``
in program order and stops at the first one that is not finite.  It runs
once, on an error path (``monitor.health.nan_provenance``), never per
step.

The walk computes the ops the executor's step runs (its live ops) in a
context of its own, on copies of the scope's values: the in-place
optimizer updates of the walk touch no parameter of the run.  With the
step's generator state the walk draws the step's dropout masks, so a
replay is a function of (feeds, scope state, generator state) and gives
the same answer every time.
"""

import numpy as np
import torch

from .. import registry
from ..registry import ComputeContext

__all__ = ["first_nonfinite_op"]


def _nonfinite(v):
    """True iff ``v`` is a floating tensor holding a non-finite element."""
    if not isinstance(v, torch.Tensor) or not v.is_floating_point():
        return False
    return not bool(torch.isfinite(v).all())


def _live_ops(program, feed_names, scope):
    """The op indices the executor's step runs, and the forward ops whose
    generic grad runs (the executor's analysis, with no fetch)."""
    from ..executor import Executor

    _, _, live, _, graph_ops = Executor._analyze(
        None, program, feed_names, scope, [])
    return [i for i, on in enumerate(live) if on], graph_ops


def first_nonfinite_op(program, feed, scope, place=None,
                       generator_state=None, classify=None):
    """Walk ``program``'s global block op by op and return the first op
    whose output is non-finite:

    ``{"op_index", "op_type", "out_var", "layer", "in_vars"}``

    or None when every output stays finite.  ``feed`` maps names to
    arrays or tensors; the other inputs come from ``scope`` (copied);
    ``place`` is the executor's (default the CPU); ``classify`` maps
    parameter names to layer-class labels (the health probe's plan), so
    the hit names the layer; ``in_vars`` lists the op's inputs that were
    already non-finite (a feed, or a poisoned parameter)."""
    device = place.device if place is not None else torch.device("cpu")
    block = program.global_block()
    env = {}
    for n, v in feed.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        var = block._find_var_recursive(n)
        dtype = var.dtype if var is not None and var.dtype is not None \
            else t.dtype
        env[n] = t.to(device=device, dtype=dtype)
    generator = torch.Generator(device=device)
    if generator_state is not None:
        generator.set_state(generator_state)
    else:
        generator.manual_seed(int(program.random_seed or 0))
    indices, graph_ops = _live_ops(program, sorted(env), scope)
    ctx = ComputeContext(device, generator, len(block.ops),
                         program._amp_policy, program, graph_ops)
    classify = classify or {}
    for i in indices:
        op = block.ops[i]
        for n in op.input_arg_names:
            if n and n not in env and scope is not None \
                    and scope.has_var(n):
                val = scope.var(n)
                val = val if isinstance(val, torch.Tensor) else \
                    torch.from_numpy(np.ascontiguousarray(val))
                env[n] = val.to(device=device, copy=True)
        registry.compute_op(op, env, ctx, op_index=i)
        for out in op.output_arg_names:
            if not out or out not in env:
                continue
            if _nonfinite(env[out]):
                layer = None
                bad_ins = []
                for n in op.input_arg_names:
                    if layer is None and n in classify:
                        layer = classify[n]
                    if n in env and _nonfinite(env[n]):
                        bad_ins.append(n)
                return {"op_index": i, "op_type": op.type,
                        "out_var": out, "layer": layer,
                        "in_vars": bad_ins}
    return None
