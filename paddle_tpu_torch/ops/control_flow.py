"""Control-flow ops: ``recurrent`` (``StaticRNN`` / ``DynamicRNN``),
``conditional_block``, ``while`` with its ``while_grad``, the tensor arrays
(``array_write``, ``array_read``, ``lod_array_length``), the predicated
``split_lod_tensor`` / ``merge_lod_tensor`` of ``IfElse``, and
``beam_search`` / ``beam_search_decode`` (counterpart of
``paddle_tpu/ops/control_flow.py``).

A sub-block op carries every external the sub-block reads as an input of
its own: for ``recurrent`` float step inputs (``Inputs``) apart from
integer ones (``IntInputs``), the memories' initial values
(``InitStates``) and an optional [B] ``Length``; for all of them float
externals (``Params``: weights, and activations of the enclosing block
such as an encoder's output) apart from the others (``Consts``).  So the
executor's liveness and its freeing of temporaries see the sub-block's
reads as the op's, and the generic grad reaches the float slots and stops
at the rest.  The sub-block's ops run through ``registry.compute_op`` (so
the AMP policy applies inside) in a context of their own
(``ComputeContext.sub_context``).

``recurrent``: where the JAX package lowers the loop to ``lax.scan``, the
port runs it as a Python loop over the steps: step t binds each step
input's slice t and the memories' current values, casts each updated
memory back to its memory's dtype, and stacks the step outputs.  With a
``Length``, a row whose length is at most t keeps its memories and emits
zeros.  On the card the loop is unrolled into the step's CUDA graph.

``conditional_block`` is predicated where the JAX op runs one branch
(``lax.cond``): the body always runs and ``torch.where`` keeps the carried
values when the condition is false.  The forward values are the same; a
random op in the body draws whether or not its branch is taken, so the
stream of every later draw does not depend on the branch.

``while`` runs its body while its condition holds.  Every trip
(``while_trip``) is predicated: the body computes and the carried values
take the new values only where the condition held at the trip's start,
so a trip taken after the condition fell changes no bit.  All trips run
in one sub-context (step 0), so a random op in the body draws the same
seed every trip, as the JAX body, traced once, draws one key.  With
``max_trip_count`` N > 0 the loop is N trips unrolled into the step (the
JAX bounded scan), reads nothing on the host and is differentiable
(``while_grad``).  Without it the loop reads its condition on the host
after each trip: the executor runs such an op of the global block itself,
between the captured segments of its entry (``registry.splits_capture``;
``executor.segment_plan``); inside another sub-block the op's own compute
loops, which a CUDA graph cannot hold.

The ``recurrent`` op, ``conditional_block`` and a bounded ``while`` pull
their gradient back through the forward's own autograd graph when the run
holds their grad op (``keep_graph``; ``while`` keeps it itself, since its
slots mix the bool condition and integer counters with float carries), so
a ``dropout`` in the body gets the masks the forward drew.

Tensor arrays are fixed-capacity tensors [capacity, ...]; a write or read
at index i counts a negative i from the end and clamps it into
[0, capacity), as ``lax.dynamic_update_slice`` does.  ``beam_search`` keeps fixed [B, K] beams: a finished beam (its
last id ``end_id``) may only emit ``end_id`` again at no cost, and the K
best of the K x V candidates are chosen as ``lax.top_k`` chooses them,
equal scores in order of their flat index (``top_k_first_index``).
"""

import torch

from .. import registry
from ..framework import grad_var_name
from ..registry import in_var, register_op, set_output


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


# ---------------------------------------------------------------------------
# sub-block plumbing shared by conditional_block and while
# ---------------------------------------------------------------------------

def _base_env(ins, attrs):
    env = dict(zip(attrs.get("param_names", []), ins.get("Params") or []))
    env.update(zip(attrs.get("const_names", []), ins.get("Consts") or []))
    return env


def _run_body(ins, attrs, carry, sub_ctx):
    """The sub-block's values after one run over ``carry`` (bound to the
    ``carried_names``), each carried value cast back to its dtype."""
    carried = attrs["carried_names"]
    env = _base_env(ins, attrs)
    env.update(zip(carried, carry))
    for i, op in enumerate(sub_ctx.program.block(attrs["sub_block"]).ops):
        registry.compute_op(op, env, sub_ctx, op_index=i)
    return [env[n].to(c.dtype) for n, c in zip(carried, carry)]


# ---------------------------------------------------------------------------
# conditional_block
# ---------------------------------------------------------------------------

def _cond_block_compute(ins, attrs, ctx, op_index):
    carry = list(ins.get("LoopVars") or [])
    new = _run_body(ins, attrs, carry, ctx.sub_context(op_index, 0))
    pred = ins["Cond"][0].all()
    return {"Out": [torch.where(pred, n, c) for n, c in zip(new, carry)]}


register_op(
    "conditional_block", ["Cond", "LoopVars", "Params", "Consts"], ["Out"],
    infer=None, compute=_cond_block_compute,
    no_grad_inputs=("Cond", "Consts"), keep_graph=True)


# ---------------------------------------------------------------------------
# while and while_grad
# ---------------------------------------------------------------------------

_WHILE_GRAPH = "__while_graph__"


def cond_index(attrs):
    """The position of the condition among a while op's carried values."""
    return list(attrs["carried_names"]).index(attrs["cond_name"])


def while_trip(ins, attrs, ctx, op_index, carry):
    """One predicated trip of while op ``op_index`` over ``carry`` (its
    carried values in ``carried_names`` order): the body's new values
    where the condition holds at the trip's start, ``carry``'s where it
    does not."""
    pred = carry[cond_index(attrs)].all()
    new = _run_body(ins, attrs, carry, ctx.sub_context(op_index, 0))
    return [torch.where(pred, n, c) for n, c in zip(new, carry)]


def host_loop(ins, attrs, ctx, op_index, carry):
    """Predicated trips of while op ``op_index`` over ``carry`` until its
    condition, read on the host after each trip, is false: (the carried
    values, the trips).  The first trip runs even when the condition
    starts false, and then changes nothing."""
    ci, trips = cond_index(attrs), 0
    while True:
        carry = while_trip(ins, attrs, ctx, op_index, carry)
        trips += 1
        if not bool(carry[ci].all()):
            return carry, trips


def _bounded_loop(ins, attrs, ctx, op_index):
    carry = list(ins["LoopVars"])
    for _ in range(int(attrs["max_trip_count"])):
        carry = while_trip(ins, attrs, ctx, op_index, carry)
    return carry


def _float_positions(vals):
    return [i for i, v in enumerate(vals)
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def _bounded_loop_with_leaves(ins, attrs, ctx, op_index):
    """The bounded loop run under autograd with the float loop vars and
    params as fresh leaves: (float loop-var positions, float param
    positions, the leaves, the carried outputs)."""
    lv, pr = list(ins["LoopVars"]), list(ins.get("Params") or [])
    d_lv, d_pr = _float_positions(lv), _float_positions(pr)
    with torch.enable_grad():
        for i in d_lv:
            lv[i] = lv[i].detach().requires_grad_()
        for i in d_pr:
            pr[i] = pr[i].detach().requires_grad_()
        full = dict(ins, LoopVars=lv, Params=pr)
        outs = _bounded_loop(full, attrs, ctx, op_index)
    leaves = [lv[i] for i in d_lv] + [pr[i] for i in d_pr]
    return d_lv, d_pr, leaves, outs


def _while_compute(ins, attrs, ctx, op_index):
    if attrs.get("max_trip_count", 0):
        if op_index not in ctx.graph_ops:
            return {"Out": _bounded_loop(ins, attrs, ctx, op_index)}
        # the run holds this loop's while_grad: keep the graph for it
        saved = _bounded_loop_with_leaves(ins, attrs, ctx, op_index)
        ctx.saved[(op_index, _WHILE_GRAPH)] = saved
        return {"Out": [o.detach() for o in saved[3]]}
    carry = list(ins["LoopVars"])
    if carry[0].is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "an unbounded while op (sub-block %d) cannot run inside a CUDA "
            "graph: it reads its condition on the host every trip"
            % attrs["sub_block"])
    return {"Out": host_loop(ins, attrs, ctx, op_index, carry)[0]}


def _while_grad_maker(op, no_grad_set):
    if not op.attrs.get("max_trip_count", 0):
        raise RuntimeError(
            "cannot differentiate through a While loop without a declared "
            "bound: its trip count is read on the host. Pass While(cond, "
            "max_trip_count=N) for a bounded, predicated (and "
            "differentiable) loop, or use StaticRNN/DynamicRNN for "
            "recurrence over a sequence.")
    g_inputs = {slot: list(op.inputs.get(slot, []))
                for slot in ("Condition", "LoopVars", "Params", "Consts")}
    # Out names alias LoopVars (the in-place while contract), so their
    # grad names alias too: the grad op reads the output-side grads and
    # writes the input-side ones
    g_inputs["GRAD::Out"] = [grad_var_name(n) for n in op.outputs["Out"]]
    g_outputs, any_grad = {}, False
    for slot in ("LoopVars", "Params"):
        outs = []
        for n in op.inputs.get(slot, []):
            if n in no_grad_set:
                outs.append("")
            else:
                outs.append(grad_var_name(n))
                any_grad = True
        g_outputs["GRAD::" + slot] = outs
    if not any_grad:
        return []
    return [dict(type="while_grad", inputs=g_inputs, outputs=g_outputs,
                 attrs=dict(op.attrs))]


def _while_grad_infer(gop, block):
    for slot in ("LoopVars", "Params"):
        for n, g in zip(gop.inputs.get(slot, []),
                        gop.outputs.get("GRAD::" + slot, [])):
            if not g:
                continue
            v = block._find_var_recursive(n)
            if v is not None:
                block.create_var(name=g, shape=v.shape, dtype=v.dtype,
                                 persistable=False)


def _while_grad_compute(ins, attrs, ctx, op_index):
    """The cotangents of the float outputs pulled back to the float loop
    vars and params, through the graph the forward kept (or a rerun of
    the bounded loop)."""
    fwd_index = attrs.get("__fwd_op_index__", op_index)
    fwd_attrs = {k: v for k, v in attrs.items() if k != "__fwd_op_index__"}
    saved = ctx.saved.pop((fwd_index, _WHILE_GRAPH), None)
    if saved is None:
        fwd_ins = {s: ins.get(s) or [] for s in
                   ("Condition", "LoopVars", "Params", "Consts")}
        saved = _bounded_loop_with_leaves(fwd_ins, fwd_attrs, ctx, fwd_index)
    d_lv, d_pr, leaves, outs = saved
    gouts = ins.get("GRAD::Out") or []
    ys, cts = [], []
    for i in d_lv:
        g = gouts[i] if i < len(gouts) else None
        if g is not None and outs[i].requires_grad:
            ys.append(outs[i])
            cts.append(g.to(outs[i].dtype))
    grads = (torch.autograd.grad(ys, leaves, cts, allow_unused=True)
             if ys else [None] * len(leaves))
    n_lv = len(ins.get("LoopVars") or [])
    n_pr = len(ins.get("Params") or [])
    g_lv, g_pr = [None] * n_lv, [None] * n_pr
    it = iter(zip(leaves, grads))
    for pos, dst in [(i, g_lv) for i in d_lv] + [(i, g_pr) for i in d_pr]:
        leaf, g = next(it)
        dst[pos] = g if g is not None else torch.zeros_like(leaf)
    return {"GRAD::LoopVars": g_lv, "GRAD::Params": g_pr}


register_op(
    "while", ["Condition", "LoopVars", "Params", "Consts"], ["Out"],
    infer=None, compute=_while_compute, grad=_while_grad_maker,
    splits_capture=lambda attrs: not attrs.get("max_trip_count", 0))

register_op(
    "while_grad",
    ["Condition", "LoopVars", "Params", "Consts", "GRAD::Out"],
    ["GRAD::LoopVars", "GRAD::Params"],
    infer=_while_grad_infer, compute=_while_grad_compute, grad=None)


# ---------------------------------------------------------------------------
# tensor arrays: fixed-capacity tensors
# ---------------------------------------------------------------------------

def _array_index(i, capacity):
    """Index tensor I as a [1] int64 index: a negative one counted from the
    end, then clamped into [0, capacity) (``lax.dynamic_slice``'s rule)."""
    i = i.reshape(-1)[:1].long()
    return torch.where(i < 0, i + capacity, i).clamp(0, capacity - 1)


def _array_write_infer(op, block):
    x = in_var(op, block, "X")
    arr = in_var(op, block, "Array")
    if arr is not None and arr.shape is not None:
        shape = arr.shape
    else:
        shape = (op.attrs["capacity"],) + tuple(x.shape or ())
    set_output(op, block, "Out", shape, x.dtype)


def _array_write_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    arr = (ins.get("Array") or [None])[0]
    if arr is None:
        arr = x.new_zeros((attrs["capacity"],) + tuple(x.shape))
    i = _array_index(ins["I"][0], arr.shape[0])
    return {"Out": torch.index_copy(arr, 0, i, x.to(arr.dtype)[None])}


register_op("array_write", ["X", "I", "Array"], ["Out"],
            infer=_array_write_infer, compute=_array_write_compute,
            no_grad_inputs=("I",))


def _array_read_infer(op, block):
    arr = in_var(op, block, "Array")
    set_output(op, block, "Out", tuple(arr.shape or ())[1:], arr.dtype)


def _array_read_compute(ins, attrs, ctx, op_index):
    arr = ins["Array"][0]
    i = _array_index(ins["I"][0], arr.shape[0])
    return {"Out": torch.index_select(arr, 0, i)[0]}


register_op("array_read", ["Array", "I"], ["Out"], infer=_array_read_infer,
            compute=_array_read_compute, no_grad_inputs=("I",))


def _array_length_compute(ins, attrs, ctx, op_index):
    x = ins["X"][0]
    return {"Out": torch.full((1,), x.shape[0], dtype=torch.int64,
                              device=x.device)}


register_op(
    "lod_array_length", ["X"], ["Out"],
    infer=lambda op, block: set_output(op, block, "Out", (1,), "int64"),
    compute=_array_length_compute, grad=None)


# ---------------------------------------------------------------------------
# IfElse's split and merge, predicated: both branches see the whole batch
# and the merge selects rows by the mask
# ---------------------------------------------------------------------------

def _split_infer(op, block):
    x = in_var(op, block, "X")
    set_output(op, block, "OutTrue", x.shape, x.dtype)
    set_output(op, block, "OutFalse", x.shape, x.dtype)


register_op(
    "split_lod_tensor", ["X", "Mask"], ["OutTrue", "OutFalse"],
    infer=_split_infer,
    compute=lambda ins, attrs, ctx, op_index: {"OutTrue": ins["X"][0],
                                               "OutFalse": ins["X"][0]},
    no_grad_inputs=("Mask",))


def _merge_compute(ins, attrs, ctx, op_index):
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    m = ins["Mask"][0].reshape((-1,) + (1,) * (t.dim() - 1)).bool()
    return {"Out": torch.where(m, t, f)}


register_op(
    "merge_lod_tensor", ["Mask", "InTrue", "InFalse"], ["Out"],
    infer=lambda op, block: set_output(
        op, block, "Out", in_var(op, block, "InTrue").shape,
        in_var(op, block, "InTrue").dtype),
    compute=_merge_compute, no_grad_inputs=("Mask",))


# ---------------------------------------------------------------------------
# beam search over fixed [B, K] beams
# ---------------------------------------------------------------------------

def top_k_first_index(x, k):
    """The ``k`` largest values of each row of [B, N] ``x`` and their
    indices, as ``lax.top_k`` gives them: by value, equal values in order
    of their index (a stable descending sort; ``torch.topk`` promises no
    order for ties)."""
    top, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return top[:, :k], idx[:, :k]


def _beam_search_infer(op, block):
    b, k = in_var(op, block, "PreIds").shape
    set_output(op, block, "SelectedIds", (b, k), "int64")
    set_output(op, block, "SelectedScores", (b, k),
               in_var(op, block, "PreScores").dtype)
    set_output(op, block, "ParentIdx", (b, k), "int64")


def beam_candidates(pre_ids, pre_scores, scores, end_id):
    """The [B, K * V] scores of every beam's extensions by every token:
    the beam's score plus the token's; a finished beam (its last id
    ``end_id``) may only emit ``end_id`` again, at no cost."""
    b, k, v = scores.shape
    finished = pre_ids == end_id
    step = torch.where(finished[:, :, None], -1e9, scores)
    step[:, :, end_id] = torch.where(finished, 0.0, scores[:, :, end_id])
    return (pre_scores[:, :, None] + step).reshape(b, k * v)


def _beam_search_compute(ins, attrs, ctx, op_index):
    pre_ids = ins["PreIds"][0]            # [B, K]
    pre_scores = ins["PreScores"][0]      # [B, K]
    scores = ins["Scores"][0]             # [B, K, V] step log-probs
    b, k, v = scores.shape
    top, idx = top_k_first_index(
        beam_candidates(pre_ids, pre_scores, scores, attrs["end_id"]), k)
    return {"SelectedIds": idx % v, "SelectedScores": top,
            "ParentIdx": idx // v}


register_op(
    "beam_search", ["PreIds", "PreScores", "Scores"],
    ["SelectedIds", "SelectedScores", "ParentIdx"],
    infer=_beam_search_infer, compute=_beam_search_compute, grad=None)


def _beam_search_decode_infer(op, block):
    t, b, k = in_var(op, block, "Ids").shape
    set_output(op, block, "SentenceIds", (b, k, t), "int64")
    set_output(op, block, "SentenceScores", (b, k),
               in_var(op, block, "Scores").dtype)


def _beam_search_decode_compute(ins, attrs, ctx, op_index):
    """Backtrack [T, B, K] ids and parents from the final beams into
    [B, K, T] sentences.  ``beam_search`` makes every parent an index in
    [0, K); one outside is clamped into it."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    t, b, k = ids.shape
    beam = torch.arange(k, device=ids.device).expand(b, k)
    toks = [None] * t
    for s in reversed(range(t)):
        toks[s] = torch.take_along_dim(ids[s], beam, dim=1)
        beam = torch.take_along_dim(parents[s], beam, dim=1).long() \
            .clamp(0, k - 1)
    return {"SentenceIds": torch.stack(toks, dim=2).long(),
            "SentenceScores": ins["Scores"][0]}


register_op(
    "beam_search_decode", ["Ids", "Parents", "Scores"],
    ["SentenceIds", "SentenceScores"], infer=_beam_search_decode_infer,
    compute=_beam_search_decode_compute, grad=None)
