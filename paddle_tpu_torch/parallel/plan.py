"""The mesh runtime's plan: a program rewritten for one rank of a mesh.

The JAX package jit-compiles a program over a named mesh and lets GSPMD
insert every collective.  The port runs one process a device, each on
its own share of the batch and of the state, and ``plan_program`` places
the collectives into a copy of the program (``parallel/collective.py``'s
``c_*`` ops), which the port's ``Executor`` then runs as it runs any
program (one CUDA graph an entry on the card).  The copy computes what
the single-device program computes; only the order of summation differs.

**Batch.**  Every feed is split along dim 0 over the data axes (``dp``
and ``fsdp``, the populated ones).  The plan follows the split through
the forward ops (a var keeps its batch dim where its declared shape keeps
a -1; ``transpose`` moves it).  An op that reads a split var and writes
one whose declared shape holds no -1, or a ``reduce_*`` over the batch
dim (the loss's ``mean``, a token count, an ``accuracy`` or ``auc``),
couples the batch: its split inputs are gathered first (``c_allgather``),
it runs on the whole batch, every rank alike, and the gradients its grad
op gives those inputs are cut back to the rank's rows (``c_slice``).
``batch_norm`` in training syncs its statistics instead (``__sync_axes__``:
the per-channel sums of every rank added up, forward and backward).
``dropout`` and ``fused_attention`` on a split var draw their block of
the global mask (``__shard_dims__``), so dropout is the single-device
run's too.

**Gradients.**  The gradient a grad op gives a replicated input of an op
on split vars (a parameter, above all) is partial: this rank's rows'
share.  Partial gradients add up through the backward's ``sum`` and
``assign`` accumulation as they are, and are summed over the data axes
where something else first reads them: an all-reduce, or the
reduce-scatter of a sharded parameter's gradient at its optimizer op.

**State.**  A persistable var whose spec (``ParallelExecutor``'s
placement: ``param_sharding_fn``, ``sharding_rules``, the reduce
strategy) splits it is held as the rank's shard.  Before its first reader
in the forward it is gathered whole (``W@FULL``), again before its first
reader in the backward (``W@FULL@BWD``, so the forward's copy is freed in
between, as FSDP does), and its gradient is reduce-scattered to the shard
its optimizer op updates.  An optimizer state var held at another spec
than its parameter (a replicated bias with ZeRO-sharded moments) is
resharded to the parameter's spec around the op.  An embedding table
whose rows are split over axes that do not split the batch (``ep``) is
not gathered: its ``lookup_table`` reads the rank's rows and sums the
activations over the table axes, and its gradient stays row-local
(``parallel/embedding.py``).

**Tensor parallelism** (``tensor_parallel``).  On ``SpecLayout``'s
lineage a ``mul`` whose weight splits its columns over ``tp`` runs on
the rank's columns, the ops after it run on the rank's share (a
``reshape`` with its head count made local, ``fused_attention`` on the
rank's heads, whose dropout hash takes the head offset), and the ``mul``
whose weight splits its rows sums its partial product over ``tp``; the
column-parallel input's gradient is summed over ``tp`` too.  Its weights
are gathered only over their other axes.  Any other op that reads a
``tp``-split var reads it gathered.

**Fetches.**  A fetched split var is gathered along its batch dim, a
sharded state var gathered whole, a partial gradient summed: every rank
fetches the global value, so a skip guard watching the fetches reaches
the same verdict on every rank.

**Sequence and pipeline axes.**  Every op runs whole on each ``sp`` and
``pp`` rank (their ranks hold the same rows), as GSPMD keeps the JAX
package's ops outside its ring and its pipeline replicated over those
axes.  Under ``sequence_parallel`` each ``fused_attention`` op and its
grad get ``__ring_axis__``: the op slices its time block, runs the ring
and gathers its output itself when the run's shapes allow it
(``ops/attention.py``), since the sequence length is known only at run
time.  Each ``pipeline_region`` op and its grad get the schedule and the
microbatch count (``__pipeline_schedule__``,
``__pipeline_microbatches__``) and, where the region's batch is split,
the data axes (``__batch_axes__``); the op runs its schedule over ``pp``
and sums its gradients over ``pp`` itself (``ops/pipeline_region.py``).

A collective over axes of extent 1 does nothing, so at world 1 the plan's
program launches exactly what the single-device program launches.
Not covered: batch coupling or a sharded parameter inside a control-flow
op's sub-block (raises for the parameter).
"""

import copy

from ..framework import Operator
from . import collective  # noqa: F401  (registers the c_* ops)
from .mesh import AXIS_PP, AXIS_SP, AXIS_TP
from .mesh import PartitionSpec as P

__all__ = ["Plan", "plan_program", "batch_vars"]

GATHER, FULL, FULL_BWD, FETCH, AT = ("@GATHER", "@FULL", "@FULL@BWD",
                                     "@FETCH", "@AT_PARAM")

_REDUCE_OPS = {"reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_prod", "reduce_all", "reduce_any"}
_ACCUMULATE = {"sum", "assign"}


class Plan:
    """A rank's program and what the executor needs around it: the names
    to fetch for the caller's fetch list, the state specs, and the
    collectives' axes (``axes_used``, whose groups every rank makes before
    the first run)."""

    def __init__(self, program, fetch_names, specs, axes_used, counts,
                 batch_fetches):
        self.program = program
        self.fetch_names = fetch_names
        self.specs = specs
        self.axes_used = axes_used
        # {op type: how many the plan inserted}
        self.counts = counts
        # the caller's fetches that come back batch-major (trimmed after a
        # replication-padded ragged batch)
        self.batch_fetches = batch_fetches


def _is_grad(op):
    return "__fwd_op_index__" in op.attrs


def _is_optimizer(op):
    ps = op.inputs.get("Param", [])
    return bool(ps) and ps[0] in op.outputs.get("ParamOut", [])


def _declared(block, name):
    v = block._find_var_recursive(name)
    return None if v is None or v.shape is None else tuple(v.shape)


def _sub_block_reads(program):
    names = set()
    for blk in program.blocks[1:]:
        for op in blk.ops:
            names.update(n for n in op.input_arg_names if n)
    return names


def batch_vars(program, feed_names, data_axes_live):
    """{var: batch dim} of the global block's forward vars, and the
    indices of the ops that couple the batch (``plan_program``'s forward
    analysis; empty when no data axis is populated)."""
    block = program.global_block()
    bdim, coupled = {}, set()
    if not data_axes_live:
        return bdim, coupled
    for n in feed_names:
        shape = _declared(block, n)
        if shape is None or len(shape) >= 1:
            bdim[n] = 0
    for i, op in enumerate(block.ops):
        if _is_grad(op) or _is_optimizer(op):
            continue
        ins = [n for n in op.input_arg_names if n in bdim]
        outs = [n for n in op.output_arg_names if n]
        if not ins:
            for n in outs:
                bdim.pop(n, None)
            continue
        d = bdim[ins[0]]
        if op.type == "batch_norm" and not op.attrs.get("is_test", False) \
                and not op.attrs.get("use_global_stats", False):
            for n in outs:
                bdim.pop(n, None)
            for n in op.outputs.get("Y", []):
                bdim[n] = d
            continue
        couples = False
        if op.type in _REDUCE_OPS:
            shape = _declared(block, ins[0])
            rank = len(shape) if shape is not None else None
            dims = op.attrs.get("dim", [])
            dims = dims if isinstance(dims, (list, tuple)) else [dims]
            if op.attrs.get("reduce_all", False) or not dims or \
                    (rank is not None and d in [x % rank for x in dims]):
                couples = True
        if op.type in ("transpose", "transpose2"):
            d = list(op.attrs["axis"]).index(d)
        new = {}
        for n in outs:
            v = block._find_var_recursive(n)
            shape = None if v is None else v.shape
            if v is not None and v.persistable:
                couples = True
            elif shape is not None and (-1 not in shape or d >= len(shape)
                                        or shape[d] != -1):
                couples = True
            new[n] = d
        if couples:
            coupled.add(i)
            for n in outs:
                bdim.pop(n, None)
        else:
            bdim.update(new)
    return bdim, coupled


# ops that keep a tp-split var's split in place (elementwise, and the
# dropout mask drawn at the global shape)
_TP_UNARY = {"relu", "gelu", "tanh", "sigmoid", "scale", "cast", "dropout"}


def _at_use(spec, axis=AXIS_TP):
    """``spec`` with only ``axis`` kept: how a tensor-parallel parameter is
    used (its ``tp`` split stays; other axes are gathered)."""
    return P(*[axis if spec.axes(d) == (axis,) or axis in spec.axes(d)
               else None for d in range(len(spec))])


def tensor_parallel(ops, block, specs, mesh, bdim):
    """The tensor-parallel plan (Megatron's pairing on ``SpecLayout``'s
    lineage): a ``mul`` whose weight splits its columns over ``tp`` runs on
    the rank's columns (column-parallel), the ops after it that keep the
    split (``_TP_UNARY``, ``elementwise_add`` of a bias split alike,
    ``reshape`` with its head count made local, ``transpose``,
    ``fused_attention`` on the rank's heads) run on the rank's share, and
    a ``mul`` whose weight splits its rows over ``tp`` on a split input
    (row-parallel) sums its partial product over ``tp``.  Returns
    (tp-local params {name: at-use spec}, {var: its split dim}, the
    column- and row-parallel op indices, {op index: [(var, dim)]} of the
    other ops that read a split var, which gather it first, {op index:
    its local ``shape`` attr} of the reshapes on a split var)."""
    k = mesh.axis_size(AXIS_TP)
    if k <= 1:
        return {}, {}, set(), set(), {}, {}

    def wspec(name):
        spec = specs.get(name)
        v = block._find_var_recursive(name)
        if spec is None or v is None or not v.persistable or v.shape is None:
            return None
        return _at_use(spec)

    tdim, col, row, gathers, local = {}, set(), set(), {}, {}
    reshaped = {}
    for i, op in enumerate(ops):
        if _is_grad(op) or _is_optimizer(op):
            continue
        ins = [n for n in op.input_arg_names if n in tdim]
        outs = [n for n in op.output_arg_names if n]
        if op.type == "mul" and op.attrs.get("y_num_col_dims", 1) == 1:
            x, y = op.inputs["X"][0], op.inputs["Y"][0]
            u = wspec(y)
            xs = _declared(block, x)
            if u is not None and len(u) == 2 and u.axes(1) == (AXIS_TP,) \
                    and not u.axes(0) and x not in tdim:
                col.add(i)
                local[y] = u
                for n in outs:
                    tdim[n] = len(_declared(block, n) or xs) - 1
                continue
            if u is not None and u.axes(0) == (AXIS_TP,) and \
                    not (len(u) > 1 and u.axes(1)) and x in tdim and \
                    xs is not None and tdim[x] == len(xs) - 1 and \
                    op.attrs.get("x_num_col_dims", 1) == len(xs) - 1:
                row.add(i)
                local[y] = u
                for n in outs:
                    tdim.pop(n, None)
                continue
        if ins:
            d = tdim[ins[0]]
            keep = None
            if op.type in _TP_UNARY and op.inputs.get("X", [""])[0] in tdim:
                keep = d
            elif op.type == "elementwise_add" and op.inputs["X"][0] in tdim \
                    and op.inputs["Y"][0] not in tdim:
                b = op.inputs["Y"][0]
                u = wspec(b)
                xs = _declared(block, op.inputs["X"][0])
                if u is not None and u == P(AXIS_TP) and xs is not None \
                        and d == len(xs) - 1:
                    local[b] = u
                    keep = d
            elif op.type in ("reshape", "reshape2"):
                shape = list(op.attrs.get("shape", []))
                j = next((j for j, v in enumerate(shape) if v > 0), None)
                if j is not None and all(v == 0 for v in shape[:j]) \
                        and d >= j and shape[j] % k == 0:
                    shape[j] //= k
                    reshaped[i] = shape
                    keep = j
            elif op.type in ("transpose", "transpose2"):
                keep = list(op.attrs["axis"]).index(d)
            elif op.type == "fused_attention" and all(
                    tdim.get(op.inputs[s][0]) == 1 for s in ("Q", "K", "V")):
                keep = 1
            if keep is not None:
                for n in outs:
                    tdim[n] = keep
                continue
            gathers[i] = [(n, tdim[n]) for n in dict.fromkeys(ins)]
        for n in outs:
            tdim.pop(n, None)
    return local, tdim, col, row, gathers, reshaped


class _Writer:
    """Builds the new op list: inserted ops before or after an original
    op, the vars they make declared in the block."""

    def __init__(self, block):
        self.block = block
        self.before = {}
        self.after = {}
        self.tail = []
        self.counts = {}

    def _op(self, type, x, out, attrs):
        self.counts[type] = self.counts.get(type, 0) + 1
        v = self.block._find_var_recursive(x)
        if self.block._find_var_recursive(out) is None:
            self.block.create_var(
                name=out, shape=None if v is None else v.shape,
                dtype=None if v is None else v.dtype, persistable=False,
                lod_level=0 if v is None else v.lod_level)
        return Operator(self.block, type, {"X": [x]}, {"Out": [out]}, attrs)

    def add_before(self, i, type, x, out, **attrs):
        self.before.setdefault(i, []).append(self._op(type, x, out, attrs))

    def add_after(self, i, type, x, out, **attrs):
        self.after.setdefault(i, []).append(self._op(type, x, out, attrs))

    def add_tail(self, type, x, out, **attrs):
        self.tail.append(self._op(type, x, out, attrs))

    def ops(self, original):
        out = []
        for i, op in enumerate(original):
            out += self.before.get(i, [])
            out.append(op)
            out += self.after.get(i, [])
        return out + self.tail


def _rename_inputs(op, old, new, slots=None):
    for slot, names in op.inputs.items():
        if slots is not None and not slots(slot):
            continue
        op.inputs[slot] = [new if n == old else n for n in names]


def _forward_slot(slot):
    return not slot.startswith(("Out::", "GRAD::"))


def _spec_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def plan_program(program, mesh, rank, specs, feed_names, fetch_names,
                 data_axes, runtime, sequence_parallel=True,
                 pipeline_schedule=None, pipeline_microbatches=None):
    """A rank's copy of ``program`` on ``mesh`` (``Plan``).  ``specs``:
    {persistable var: PartitionSpec} of the state the program reads;
    ``data_axes``: the axes the batch splits over, in order; the other
    arguments are ``BuildStrategy``'s sequence and pipeline knobs."""
    p = copy.deepcopy(program)
    p._mesh_runtime = runtime
    block = p.global_block()
    ops = list(block.ops)
    live_data = tuple(a for a in data_axes if mesh.axis_size(a) > 1)
    D = list(live_data)
    axes_used = set()
    if D:
        axes_used.add(tuple(D))
    w = _Writer(block)
    specs = {n: s for n, s in specs.items() if s != P()
             and mesh.extent([a for i in range(len(s))
                              for a in s.axes(i)]) > 1}

    bdim, coupled = batch_vars(p, feed_names, live_data)
    # the forward ops on the rank's rows (read before any input is
    # renamed): their grad ops give replicated inputs partial gradients
    split_ops = {i for i, op in enumerate(ops)
                 if not _is_grad(op) and i not in coupled
                 and op.type != "batch_norm"
                 and any(n in bdim for n in op.input_arg_names)} if D \
        else set()
    orig_inputs = {i: {s: list(v) for s, v in ops[i].inputs.items()}
                   for i in split_ops}
    grads_of = {}
    for j, op in enumerate(ops):
        if _is_grad(op):
            grads_of.setdefault(op.attrs["__fwd_op_index__"], []).append(j)

    # -- sharded state: table mode or gathered at use --------------------
    sub_reads = _sub_block_reads(p)
    lookups = {}
    for i, op in enumerate(ops):
        if op.type == "lookup_table" and not _is_grad(op):
            for wn in op.inputs.get("W", []):
                lookups.setdefault(wn, []).append(i)
    table_mode = {}
    for n, spec in specs.items():
        if n in sub_reads:
            raise NotImplementedError(
                "var %r, which a control-flow op's block reads, cannot be "
                "sharded by the mesh runtime; give it a replicated spec"
                % n)
        t_axes = spec.axes(0)
        readers = [i for i, op in enumerate(ops)
                   if n in op.input_arg_names and not _is_optimizer(op)
                   and not _is_grad(op)]
        if n in lookups and t_axes and len(spec) == 1 \
                and not set(t_axes) & set(D) and readers \
                and all(ops[i].type == "lookup_table" for i in readers):
            table_mode[n] = t_axes
    for n, t_axes in table_mode.items():
        axes_used.add(tuple(t_axes))
        for i in lookups[n]:
            ops[i].attrs["__table_axes__"] = list(t_axes)
            for j in grads_of.get(i, []):
                ops[j].attrs["__table_axes__"] = list(t_axes)

    tp_local, tdim, tp_col, tp_row, tp_gathers, reshaped = tensor_parallel(
        ops, block, {n: s for n, s in specs.items() if n not in table_mode},
        mesh, bdim)
    for i, shape in reshaped.items():
        # the grad ops rerun the forward with their own copy of the attr
        for j in [i] + grads_of.get(i, []):
            ops[j].attrs["shape"] = list(shape)
    if tp_local:
        axes_used.add((AXIS_TP,))

    def at_use(n):
        """The spec a state var is used at: a tp-local param's ``tp``
        split, a table's rows, else whole."""
        if n in table_mode:
            return specs[n]
        return tp_local.get(n, P())

    bwd0 = next((i for i, op in enumerate(ops) if _is_grad(op)), len(ops))
    gathered = {}      # sharded var -> (forward name, backward name)
    for n, spec in specs.items():
        if n in table_mode or at_use(n) == spec:
            continue
        first_write = next((i for i, op in enumerate(ops)
                            if n in op.output_arg_names), len(ops))
        fwd_readers, bwd_readers = [], []
        for i, op in enumerate(ops[:first_write]):
            if n not in op.input_arg_names or _is_optimizer(op):
                continue
            (bwd_readers if i >= bwd0 else fwd_readers).append(i)
        names = (n + FULL, n + FULL_BWD)
        for readers, full in zip((fwd_readers, bwd_readers), names):
            if not readers:
                continue
            w.add_before(readers[0], "c_reshard", n, full,
                         src=_spec_list(spec),
                         dst=_spec_list(at_use(n)))
            for i in readers:
                _rename_inputs(ops[i], n, full)
        axes_used.update(tuple(spec.axes(d)) for d in range(len(spec))
                         if spec.axes(d))
        gathered[n] = names

    def gather_in(i, n, axes, dim, tag):
        """Op ``i`` reads ``n`` gathered whole along ``dim`` over ``axes``;
        its grad ops' gradient of ``n`` is cut back to the rank's block."""
        op = ops[i]
        g = "%s%s%s%d" % (n, GATHER, tag, i)
        w.add_before(i, "c_allgather", n, g, axes=axes, dim=dim)
        _rename_inputs(op, n, g)
        for j in grads_of.get(i, []):
            gop = ops[j]
            fwd_names = {s: list(v) for s, v in gop.inputs.items()
                         if _forward_slot(s)}
            _rename_inputs(gop, n, g, _forward_slot)
            for slot, outs in gop.outputs.items():
                if not slot.startswith("GRAD::"):
                    continue
                src = fwd_names.get(slot[len("GRAD::"):], [])
                for k, o in enumerate(outs):
                    if o and k < len(src) and src[k] == n:
                        outs[k] = o + "@GLOBAL" + tag
                        w.add_after(j, "c_slice", o + "@GLOBAL" + tag, o,
                                    axes=axes, dim=dim)

    # -- batch-coupled ops: gather in, run whole, slice the gradients out
    for i in sorted(coupled):
        for n in list(dict.fromkeys(x for x in ops[i].input_arg_names
                                    if x in bdim)):
            gather_in(i, n, D, bdim[n], "")

    # -- tensor parallelism: the ops on a split var's share --------------
    for i, pairs in tp_gathers.items():
        for n, d in pairs:
            gather_in(i, n, [AXIS_TP], d, "TP")
    for i in tp_row:
        # the partial product summed over tp, before any reader (a bias)
        out = ops[i].outputs["Out"][0]
        w.add_after(i, "c_allreduce", out, out, axes=[AXIS_TP])
    for i in tp_col:
        for j in grads_of.get(i, []):
            # the input's gradient from the rank's columns: a tp share
            for o in ops[j].outputs.get("GRAD::X", []):
                if o:
                    w.add_after(j, "c_allreduce", o, o, axes=[AXIS_TP])

    # -- randomness and statistics on split vars -------------------------
    for i, op in enumerate(ops):
        if _is_grad(op) or i in coupled:
            continue
        if op.type == "dropout":
            x = op.inputs["X"][0]
            dims = [[bdim[x], D]] if x in bdim and D else []
            if x in tdim:
                dims.append([tdim[x], [AXIS_TP]])
            if dims:
                op.attrs["__shard_dims__"] = dims
        elif op.type == "fused_attention":
            q = op.inputs["Q"][0]
            dims = [[0, D]] if q in bdim and D else []
            if tdim.get(q) == 1:
                dims.append([1, [AXIS_TP]])
            if dims:
                op.attrs["__shard_dims__"] = dims
                for j in grads_of.get(i, []):
                    ops[j].attrs["__shard_dims__"] = dims
        elif op.type == "batch_norm" and op.inputs["X"][0] in bdim:
            op.attrs["__sync_axes__"] = list(D)
            for j in grads_of.get(i, []):
                ops[j].attrs["__sync_axes__"] = list(D)

    # -- the sequence and pipeline axes: marks their ops read -----------
    sp_live = sequence_parallel and mesh.axis_size(AXIS_SP) > 1
    if sp_live:
        axes_used.add((AXIS_SP,))
    for i, op in enumerate(ops):
        if _is_grad(op):
            continue
        marks = {}
        if op.type == "fused_attention" and sp_live:
            marks["__ring_axis__"] = AXIS_SP
        elif op.type == "pipeline_region":
            marks["__pipeline_schedule__"] = pipeline_schedule or ""
            marks["__pipeline_microbatches__"] = int(
                pipeline_microbatches or 0)
            if D and op.inputs["Carry"][0] in bdim:
                marks["__batch_axes__"] = list(D)
            if mesh.axis_size(AXIS_PP) > 1:
                axes_used.add((AXIS_PP,))
        for j in [i] + grads_of.get(i, []):
            ops[j].attrs.update(marks)

    # -- gradients: partial where a split op gave a replicated input one -
    partial = {}       # grad var -> "dense" | "sparse"
    param_of_grad = {}
    for i, op in enumerate(ops):
        if _is_optimizer(op):
            param_of_grad[op.inputs["Grad"][0]] = op.inputs["Param"][0]

    def sync(i, n, consumer):
        kind = partial.pop(n)
        pname = param_of_grad.get(n) if consumer is not None and \
            _is_optimizer(consumer) and consumer.inputs["Grad"][0] == n \
            else None
        spec = specs.get(pname) if pname else None
        if kind == "sparse":
            if spec is not None:
                # the optimizer op gathers and localizes the rows itself
                consumer.attrs["__table_axes__"] = list(spec.axes(0))
                consumer.attrs["__batch_axes__"] = list(D)
                v = block._find_var_recursive(pname)
                consumer.attrs["__table_rows__"] = int(v.shape[0])
                axes_used.add(tuple(spec.axes(0)))
            else:
                w.add_before(i, "c_sparse_allgather", n, n, axes=D)
            return
        if spec is not None:
            src = at_use(pname)
            w.add_before(i, "c_reduce_shard", n, n, reduce_axes=D,
                         src=_spec_list(src), dst=_spec_list(spec))
            spec_done.add(n)
        else:
            w.add_before(i, "c_allreduce", n, n, axes=D)

    spec_done = set()
    for i, op in enumerate(ops):
        reads = [n for n in op.input_arg_names if n in partial]
        accum = op.type in _ACCUMULATE and not _is_grad(op) and reads \
            and all(n in partial for n in op.input_arg_names if n)
        if accum:
            kinds = {partial.pop(n) for n in reads}
            for n in op.output_arg_names:
                if n:
                    partial[n] = kinds.pop() if len(kinds) == 1 else "dense"
            continue
        for n in dict.fromkeys(reads):
            sync(i, n, op)
        if _is_grad(op):
            f = op.attrs["__fwd_op_index__"]
            if f not in split_ops:
                continue
            for slot, outs in op.outputs.items():
                if not slot.startswith("GRAD::"):
                    continue
                src = orig_inputs[f].get(slot[len("GRAD::"):], [])
                for k, o in enumerate(outs):
                    if not o or k >= len(src) or src[k] in bdim:
                        continue
                    v = block._find_var_recursive(o)
                    sparse = v is not None and getattr(v, "type", None) \
                        is not None and "SELECTED" in str(v.type).upper()
                    partial[o] = "sparse" if sparse else "dense"
    for n in list(partial):
        if n in fetch_names:
            w.add_tail("c_allreduce", n, n, axes=D)
        partial.pop(n)

    # -- optimizer ops: the grad at the param's spec, state resharded ----
    for i, op in enumerate(ops):
        if not _is_optimizer(op):
            continue
        pname = op.inputs["Param"][0]
        pspec = specs.get(pname, P())
        gname = op.inputs["Grad"][0]
        if pspec != P() and gname not in spec_done:
            gv = block._find_var_recursive(gname)
            sparse = gv is not None and "SELECTED" in str(
                getattr(gv, "type", "")).upper()
            if not sparse and not op.attrs.get("__table_axes__"):
                src = at_use(pname)
                if src != pspec:
                    w.add_before(i, "c_reshard", gname, gname,
                                 src=_spec_list(src), dst=_spec_list(pspec))
        pshape = _declared(block, pname)
        for slot, names in op.inputs.items():
            if slot in ("Param", "Grad", "LearningRate"):
                continue
            for n in names:
                sspec = specs.get(n, P())
                if sspec == pspec or _declared(block, n) != pshape:
                    continue
                at = n + AT
                w.add_before(i, "c_reshard", n, at, src=_spec_list(sspec),
                             dst=_spec_list(pspec))
                _rename_inputs(op, n, at)
                for oslot, outs in op.outputs.items():
                    if n in outs:
                        op.outputs[oslot] = [at if o == n else o
                                             for o in outs]
                        w.add_after(i, "c_reshard", at, n,
                                    src=_spec_list(pspec),
                                    dst=_spec_list(sspec))
                axes_used.update(tuple(sspec.axes(d))
                                 for d in range(len(sspec)) if sspec.axes(d))

    # -- fetches: the global value on every rank --------------------------
    out_names, batch_fetches = [], set()
    for n in fetch_names:
        if n in tdim:
            w.add_tail("c_allgather", n, n + "@TPFETCH", axes=[AXIS_TP],
                       dim=tdim[n])
            n_tp = n + "@TPFETCH"
        else:
            n_tp = n
        if n in bdim and D:
            w.add_tail("c_allgather", n_tp, n + FETCH, axes=D, dim=bdim[n])
            out_names.append(n + FETCH)
            batch_fetches.add(n)
        elif n in specs:
            w.add_tail("c_reshard", n, n + FETCH,
                       src=_spec_list(specs[n]), dst=[])
            out_names.append(n + FETCH)
        else:
            out_names.append(n_tp)
    block.ops = w.ops(ops)
    # the grad ops name their forward op by its new index; the ops that
    # draw keep their original index's seed (registry.ComputeContext)
    new_index = {id(op): j for j, op in enumerate(block.ops)}
    moved = {i: new_index[id(op)] for i, op in enumerate(ops)}
    for op in block.ops:
        if "__fwd_op_index__" in op.attrs:
            op.attrs["__fwd_op_index__"] = moved[op.attrs["__fwd_op_index__"]]
    p._seed_map = {j: i for i, j in moved.items() if i != j}
    # the health probe: classes from the source program, and each var's
    # share of the global sums (1 / its replicas; a gradient as the shard
    # its optimizer op reads)
    p._mesh_source = program
    p._mesh_weights = _replica_weights(p, mesh, specs, param_of_grad)
    p._version += 1
    return Plan(p, out_names, specs, sorted(axes_used), dict(w.counts),
                batch_fetches)


def _replica_weights(program, mesh, specs, param_of_grad):
    weights = {}
    for v in program.list_vars():
        if v.persistable:
            spec = specs.get(v.name, P())
            split = mesh.extent([a for d in range(len(spec))
                                 for a in spec.axes(d)])
            weights[v.name] = split / mesh.size
    for g, p in param_of_grad.items():
        weights[g] = weights.get(p, 1.0 / mesh.size)
    return weights
