"""``pipeline_region``: a ``layers.Pipeline`` region's stages, run in
sequence or as a pipeline schedule over the ``pp`` mesh axis
(counterpart of ``paddle_tpu/ops/pipeline_region.py``).

The op owns a sub-block whose ops split into structurally identical
stages (``stage_bounds``).  Every stage runs stage 0's op list (the
template) bound to its own parameters, stacked by slot; the full
structural check (op types, attrs, and the role of every input name:
carry, parameter slot, side, const, stage-local producer) and its error
messages are the JAX package's.

* Sequential path (no populated ``pp`` axis, or one the region's stage
  count does not fit): for each microbatch, every stage in order.  This
  is the ground truth the schedules are held to.
* A ``ParallelExecutor`` mesh with a ``pp`` axis (the plan sets
  ``__pipeline_schedule__`` and ``__pipeline_microbatches__`` on the op:
  ``BuildStrategy.pipeline_schedule`` and ``pipeline_microbatches``,
  which overrides the ``microbatches`` attr on both paths):
  ``parallel.pipeline.run_schedule`` under ``gpipe`` and ``1f1b`` when
  the stage count equals the ``pp`` extent, under ``interleaved`` when it
  is a multiple (v chunks a rank, M a multiple of the extent).

Randomness is a function of (the region's seed in the run, stage,
microbatch, op, element), never of the order stages run in: each
(stage, microbatch) runs in a sub-context (``ComputeContext.
sub_context``) keyed by both, with ``counter_random`` set, so
``fused_attention`` takes its hash seed from that key and ``dropout``
draws from a counter hash of it (``ops/random.py``) instead of the run's
generator stream.  The sequential path, every schedule and the generic
grad's recompute therefore draw the same masks, and a captured replay
draws anew (the key comes from the run key).  Where the plan splits the
region's batch over data axes (``__batch_axes__``), the key also takes
the rank's data index, as the JAX package folds the dp index: the draws
then decorrelate per data shard.

The grad ``pipeline_region_grad`` is the generic grad: it reruns this
compute under autograd; on a ``pp`` mesh the schedule's backward runs
(``parallel/pipeline.py``).  Inside a stage the mesh is not exposed (no
ring inside a pipeline)."""

import torch

from .. import registry
from ..registry import in_var, register_op, set_output

__all__ = []


def _pipeline_infer(op, block):
    c = in_var(op, block, "Carry")
    set_output(op, block, "Out", c.shape, c.dtype)


def _stage_param_names(ops, param_set):
    seen, out = set(), []
    for o in ops:
        for n in o.input_arg_names:
            if n in param_set and n not in seen:
                seen.add(n)
                out.append(n)
    return out


def _stage_signature(ops, carry_in, carry_out, stage_params, side_names,
                     const_set):
    """Canonical structure of one stage: op types, attrs, and each
    input/output name's ROLE (not its spelling)."""
    pidx = {n: j for j, n in enumerate(stage_params)}
    sides = set(side_names)
    local = {}

    def role(n):
        if n == carry_in:
            return ("carry",)
        if n in pidx:
            return ("param", pidx[n])
        if n in sides:
            return ("side", n)
        if n in const_set:
            return ("const", n)
        if n in local:
            return ("local",) + local[n]
        return ("extern", n)

    sig = []
    for i, o in enumerate(ops):
        ins_sig = tuple(
            (slot, tuple(role(n) for n in names))
            for slot, names in sorted(o.inputs.items()))
        attrs_sig = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in o.attrs.items()))
        sig.append((o.type, ins_sig, attrs_sig))
        for slot, names in sorted(o.outputs.items()):
            for pos, n in enumerate(names):
                if n:
                    local[n] = (i, slot, pos)
    sig.append(("__carry_out__", role(carry_out)))
    return sig


def _structure(sub, attrs):
    """(template ops, template param names, each stage's param names),
    after the structural-identity check; kept on the sub-block for its op
    list."""
    key = (tuple(id(o) for o in sub.ops), tuple(attrs["stage_bounds"]),
           tuple(attrs["param_names"]))
    hit = getattr(sub, "_pipeline_structure", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    s_count = attrs["stages"]
    bounds = attrs["stage_bounds"]
    side_names = list(attrs["side_names"]) + \
        list(attrs.get("int_side_names", []))
    ranges = [(0 if i == 0 else bounds[i - 1], bounds[i])
              for i in range(s_count)]
    stage_ops = [sub.ops[a:e] for a, e in ranges]
    param_set = set(attrs["param_names"])
    per_stage = [_stage_param_names(ops, param_set) for ops in stage_ops]
    sigs = [_stage_signature(stage_ops[s], attrs["carry_in_names"][s],
                             attrs["carry_out_names"][s], per_stage[s],
                             side_names, set(attrs["const_names"]))
            for s in range(s_count)]
    for s in range(1, s_count):
        if sigs[s] != sigs[0]:
            for j, (a, b2) in enumerate(zip(sigs[s], sigs[0])):
                if a != b2:
                    raise ValueError(
                        "pipeline_region stages must be structurally "
                        "identical: stage %d differs from stage 0 at "
                        "element %d:\n  stage %d: %s\n  stage 0: %s"
                        % (s, j, s, a, b2))
            raise ValueError(
                "pipeline_region: stage %d signature length differs "
                "from stage 0" % s)
    out = (stage_ops[0], per_stage[0], per_stage)
    sub._pipeline_structure = (key, out)
    return out


def _pipeline_compute(ins, attrs, ctx, op_index):
    from ..parallel.mesh import AXIS_PP
    from ..parallel.pipeline import normalize_schedule, region_plan, \
        run_schedule

    sub = ctx.program.block(attrs["sub_block"])
    s_count = attrs["stages"]
    carry0 = ins["Carry"][0]
    b = carry0.shape[0]
    rt = getattr(ctx, "mesh", None)
    schedule = normalize_schedule(attrs.get("__pipeline_schedule__")
                                  or None)
    # BuildStrategy.pipeline_microbatches overrides the attr, on the
    # schedules and on the sequential ground truth alike
    virtual, m = region_plan(
        attrs, schedule, rt.extent((AXIS_PP,)) if rt is not None else 1,
        attrs.get("__pipeline_microbatches__"))
    if b % m:
        raise ValueError(
            "pipeline_region: microbatches (%d) must divide the batch (%d)"
            % (m, b))
    mb = b // m
    t_ops, t_params, per_stage = _structure(sub, attrs)
    param_vals = dict(zip(attrs["param_names"], ins.get("Params") or []))
    stage_params = []
    for s in range(s_count):
        stage_params.append([param_vals[n] for n in per_stage[s]])
    for j in range(len(t_params)):
        shapes = {tuple(stage_params[s][j].shape) for s in range(s_count)}
        if len(shapes) != 1:
            raise ValueError(
                "param %r (slot %d) has mismatched shapes across stages: "
                "%s" % (t_params[j], j, sorted(shapes)))
    const_env = dict(zip(attrs["const_names"], ins.get("Consts") or []))
    f_names = list(attrs["side_names"])
    i_names = list(attrs.get("int_side_names", []))

    def by_mb(v):
        return v.reshape((m, mb) + tuple(v.shape[1:]))

    fsides = [by_mb(v) for v in ins.get("Sides") or []]
    isides = [by_mb(v) for v in ins.get("IntSides") or []]
    carry_in0 = attrs["carry_in_names"][0]
    carry_out0 = attrs["carry_out_names"][0]
    batch_axes = tuple(attrs.get("__batch_axes__") or ())
    data_index = rt.index(batch_axes) if rt is not None and batch_axes \
        and rt.extent(batch_axes) > 1 else 0

    def apply(vs, pvals, carry, fs_t, t):
        env = dict(const_env)
        env.update(zip(t_params, pvals))
        env.update(zip(f_names, fs_t))
        env.update(zip(i_names, [v[t] for v in isides]))
        env[carry_in0] = carry
        # the stage's randomness keyed by (data shard, stage, microbatch)
        sctx = ctx.sub_context(op_index, (data_index * s_count + vs) * m + t)
        sctx.counter_random = True
        sctx.mesh = None
        sctx.n_ops = len(t_ops)
        for j, o in enumerate(t_ops):
            registry.compute_op(o, env, sctx, op_index=j)
        return env[carry_out0].to(carry0.dtype)

    x_mb = by_mb(carry0)
    if not virtual:
        outs = []
        for t in range(m):
            c = x_mb[t]
            for s in range(s_count):
                c = apply(s, stage_params[s], c, [f[t] for f in fsides], t)
            outs.append(c)
        return {"Out": torch.stack(outs).reshape(carry0.shape)}
    if schedule == "1f1b" and not carry0.is_floating_point():
        raise ValueError(
            "pipeline_region: the 1f1b schedule differentiates the carry "
            "per stage and needs a floating carry, got %s" % carry0.dtype)
    out = run_schedule(schedule, rt, AXIS_PP, x_mb, stage_params, apply,
                       fsides, virtual=virtual, out_dtype=carry0.dtype)
    return {"Out": out.reshape(carry0.shape)}


register_op(
    "pipeline_region", ["Carry", "Sides", "IntSides", "Params", "Consts"],
    ["Out"], infer=_pipeline_infer, compute=_pipeline_compute,
    no_grad_inputs=("IntSides",), stateful_random=True,
)
