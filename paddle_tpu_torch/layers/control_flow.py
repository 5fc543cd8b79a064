"""The control-flow layers (counterpart of
``paddle_tpu/layers/control_flow.py``): ``StaticRNN``, ``DynamicRNN``,
``While``, ``ConditionalBlock``, ``Switch``, ``IfElse``, the tensor arrays,
``beam_search`` / ``beam_search_decode``, the rank-table layers,
``Print`` and ``is_empty``.

``StaticRNN`` / ``DynamicRNN``, ``While`` and ``ConditionalBlock`` build a
sub-block (``Program._create_block``) from the layer calls made inside
their ``step()`` / ``block()`` and, when it closes, append one
``recurrent``, ``while`` or ``conditional_block`` op to the enclosing
block (``ops/control_flow.py``).  A ``While`` or ``ConditionalBlock``
body communicates by writing vars that exist outside it: those are the
op's carried values.  ``Switch`` chains conditional blocks; ``IfElse`` is
predicated (both branches on the whole batch, a row merge by the mask).
The op lists and attrs are the JAX package's, so the programs serialize
alike.
"""

import contextlib

from .. import unique_name
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "StaticRNN", "DynamicRNN", "While", "IfElse", "Switch",
    "ConditionalBlock", "array_write", "array_read", "array_length",
    "create_array", "beam_search", "beam_search_decode",
    "Print", "is_empty",
    "lod_rank_table", "max_sequence_len", "reorder_lod_tensor_by_rank",
    "lod_tensor_to_array", "array_to_lod_tensor",
]


def _classify_externals(sub_block, bound_names):
    """Find names read by ``sub_block``'s ops that are defined outside it.

    Returns (float_names, other_names): separated so integer externals
    (e.g. id tensors) never poison the differentiable Params slot of the
    enclosing sub-block op.
    """
    bound = set(bound_names)
    floats, others, seen = [], [], set()
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if not n or n in bound or n in seen or n in sub_block.vars:
                continue
            seen.add(n)
            v = sub_block._find_var_recursive(n)
            if v is None:
                continue
            if v.dtype is not None and v.dtype.is_floating_point:
                floats.append(n)
            else:
                others.append(n)
    return floats, others


def _written_outer_vars(sub_block):
    """Names written by sub-block ops that live in an ancestor block."""
    out = []
    for op in sub_block.ops:
        for n in op.output_arg_names:
            if n and n not in sub_block.vars and n not in out:
                if sub_block.parent_block is not None and \
                        sub_block.parent_block._find_var_recursive(n):
                    out.append(n)
    return out


# ---------------------------------------------------------------------------
# StaticRNN: fixed-length, time-major
# ---------------------------------------------------------------------------

class StaticRNN:
    """Time-major recurrence over ``[T, B, ...]`` inputs: one
    ``recurrent`` op that runs the step block once per time step.

    ::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)           # x: [T, B, D]
            h_pre = rnn.memory(init=h0)       # or shape=/batch_ref=
            h = layers.fc(concat([x_t, h_pre]), size=H, act='tanh')
            rnn.update_memory(h_pre, h)
            rnn.step_output(h)
        out = rnn()                            # [T, B, H]
    """

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.sub_block = None
        self.inputs = []           # (outer var, in-block step var)
        self.memories = {}         # pre var name -> (init var, pre var)
        self.mem_updates = {}      # pre var name -> updated in-block var
        self.outputs = []          # in-block vars to stack
        self.time_major = True

    @contextlib.contextmanager
    def step(self):
        if self.status != StaticRNN.BEFORE_RNN_BLOCK:
            raise RuntimeError("step() may only be entered once")
        program = self.helper.main_program
        self.parent_block = program.current_block()
        self.sub_block = program._create_block()
        self.status = StaticRNN.IN_RNN_BLOCK
        try:
            yield
        finally:
            program._rollback()
        self.status = StaticRNN.AFTER_RNN_BLOCK
        self._complete_op()

    def _assert_in_rnn_block(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise RuntimeError("%s() may only be called inside rnn.step()"
                               % method)

    def step_input(self, x):
        self._assert_in_rnn_block("step_input")
        if not isinstance(x, Variable):
            raise TypeError("step_input needs a Variable")
        step_var = self.sub_block.create_var(
            name=unique_name.generate(x.name + "@step"),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self.inputs.append((x, step_var))
        return step_var

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1,
               dtype="float32"):
        self._assert_in_rnn_block("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory() needs init=, or shape= AND batch_ref=")
            # the init op is emitted in the parent block, so a step var
            # reference is remapped to its outer source sequence
            for outer, step_var in self.inputs:
                if batch_ref is step_var or batch_ref.name == step_var.name:
                    batch_ref = outer
                    ref_batch_dim_idx = 1 if self.time_major else 0
                    break
            from . import tensor as tensor_layers
            parent = self.parent_block
            program = self.helper.main_program
            # temporarily emit the zero-init in the parent block
            saved = program.current_block_idx
            program.current_block_idx = parent.idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref, shape=[-1] + list(shape),
                    dtype=dtype, value=init_value,
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx)
            finally:
                program.current_block_idx = saved
        if getattr(init, "op", None) is not None and \
                init.op in self.sub_block.ops:
            raise ValueError(
                "memory init var %r is produced inside the step block; "
                "create it before entering step()/block()" % init.name)
        pre = self.sub_block.create_var(
            name=unique_name.generate("%s@mem" % init.name),
            shape=tuple(init.shape), dtype=init.dtype)
        self.memories[pre.name] = (init, pre)
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn_block("update_memory")
        if mem.name not in self.memories:
            raise ValueError("%r is not a memory of this RNN" % mem.name)
        self.mem_updates[mem.name] = var

    def step_output(self, o):
        self._assert_in_rnn_block("step_output")
        self.outputs.append(o)

    output = step_output

    def _complete_op(self):
        if not self.inputs:
            raise ValueError("StaticRNN needs at least one step_input")
        for pre_name in self.memories:
            if pre_name not in self.mem_updates:
                raise ValueError(
                    "memory %r has no update_memory()" % pre_name)
        helper = self.helper
        parent = self.parent_block
        program = helper.main_program
        saved = program.current_block_idx
        program.current_block_idx = parent.idx
        try:
            self._append_recurrent(parent)
        finally:
            program.current_block_idx = saved

    def _append_recurrent(self, parent):
        helper = self.helper
        pre_names = list(self.memories.keys())
        init_vars = [self.memories[n][0] for n in pre_names]
        post_names = [self.mem_updates[n].name for n in pre_names]
        out_names = [o.name for o in self.outputs]

        # float/int step inputs ride separate op slots (see recurrent op)
        float_in, int_in = [], []
        for outer, sv in self.inputs:
            dt = sv.dtype
            if dt is not None and dt.is_floating_point:
                float_in.append((outer, sv))
            else:
                int_in.append((outer, sv))
        step_in_names = [sv.name for _, sv in float_in]
        int_step_in_names = [sv.name for _, sv in int_in]

        bound = set(step_in_names) | set(int_step_in_names) | set(pre_names)
        params, consts = _classify_externals(self.sub_block, bound)

        self._out_vars = [
            parent.create_var(
                name=unique_name.generate("%s@out" % o.name))
            for o in self.outputs
        ]
        final_vars = [
            parent.create_var(
                name=unique_name.generate("%s@final" % n))
            for n in post_names
        ]
        parent.append_op(
            type="recurrent",
            inputs={
                "Inputs": [x.name for x, _ in float_in],
                "IntInputs": [x.name for x, _ in int_in],
                "InitStates": [v.name for v in init_vars],
                "Params": params,
                "Consts": consts,
            },
            outputs={
                "Outputs": [v.name for v in self._out_vars],
                "FinalStates": [v.name for v in final_vars],
            },
            attrs={
                "sub_block": self.sub_block.idx,
                "time_major": self.time_major,
                "is_reverse": False,
                "step_input_names": step_in_names,
                "int_step_input_names": int_step_in_names,
                "pre_state_names": pre_names,
                "state_names": post_names,
                "output_names": out_names,
                "param_names": params,
                "const_names": consts,
            })
        self._final_vars = final_vars

    def __call__(self):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise RuntimeError("RNN output requested before step() closed")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return tuple(self._out_vars)


# ---------------------------------------------------------------------------
# DynamicRNN: batch-major padded sequences masked by the @LEN companion
# ---------------------------------------------------------------------------

class DynamicRNN(StaticRNN):
    """Recurrence over padded ``[B, T, ...]`` sequences.  Steps past a
    row's length leave memories unchanged and emit zeros."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.time_major = False
        self._length_var = None

    block = StaticRNN.step

    def static_input(self, x):
        """Expose a non-stepped tensor inside the block.  Outer vars are
        visible to the sub-block as they are (padded batches need no
        reorder), so this returns ``x``."""
        self._assert_in_rnn_block("static_input")
        return x

    def step_input(self, x, length=None):
        self._assert_in_rnn_block("step_input")
        if length is None:
            from .sequence import _len_of
            length = _len_of(self.helper, x, None)
        if self._length_var is None:
            self._length_var = length
        step_var = self.sub_block.create_var(
            name=unique_name.generate(x.name + "@step"),
            shape=tuple(x.shape[:1]) + tuple(x.shape[2:]), dtype=x.dtype)
        self.inputs.append((x, step_var))
        return step_var

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               **kwargs):
        if init is None and shape is not None and self.inputs:
            kwargs.setdefault("batch_ref", self.inputs[0][0])
            kwargs.setdefault("ref_batch_dim_idx", 0)
            return super().memory(shape=shape, init_value=value,
                                  dtype=dtype, **kwargs)
        return super().memory(init=init, shape=shape, init_value=value,
                              dtype=dtype, **kwargs)

    def _append_recurrent(self, parent):
        super()._append_recurrent(parent)
        op = parent.ops[-1]
        assert op.type == "recurrent"
        if self._length_var is not None:
            op.inputs["Length"] = [self._length_var.name]
            for v in self._out_vars:
                v._seq_len_name = self._length_var.name


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While:
    """A loop over a sub-block while ``cond`` holds.  ``cond`` is a [1]
    bool var the block must update (e.g. ``layers.less_than(i, n,
    cond=cond)``).  Vars written inside the block that already exist
    outside are the loop's carried values; their shapes must not change
    from trip to trip (use fixed-capacity arrays from ``create_array`` /
    ``array_write``).

    Without ``max_trip_count`` the trip count is read on the host after
    each trip: the executor runs the loop between the captured segments
    of its entry, and a backward through it raises.  ``max_trip_count=N``
    makes it N predicated trips unrolled into the step (a trip after the
    condition fell passes the carried values through), the same for any
    run that takes at most N trips, and differentiable (``while_grad``).
    """

    def __init__(self, cond, name=None, max_trip_count=None):
        self.helper = LayerHelper("while", name=name)
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        if max_trip_count is not None and int(max_trip_count) <= 0:
            raise ValueError("max_trip_count must be positive")
        self.cond_var = cond
        self.max_trip_count = max_trip_count

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()

        carried = _written_outer_vars(sub)
        if self.cond_var.name not in carried:
            raise ValueError(
                "While block must update the condition var %r (e.g. "
                "layers.less_than(..., cond=cond))" % self.cond_var.name)
        params, consts = _classify_externals(sub, set(carried))
        # snapshot the initial carry under distinct names: the op's
        # outputs alias the carried vars (the in-place while contract), so
        # without snapshots a later grad op reading LoopVars would see the
        # final values, whose condition is already false, and every
        # gradient through the loop would be zero
        snaps = []
        for c in carried:
            snap = c + "@LOOP_IN"
            cv = parent._find_var_recursive(c)
            parent.create_var(name=snap, shape=cv.shape, dtype=cv.dtype,
                              persistable=False)
            parent.append_op(type="assign", inputs={"X": [c]},
                             outputs={"Out": [snap]}, attrs={})
            snaps.append(snap)
        parent.append_op(
            type="while",
            inputs={
                "Condition": [self.cond_var.name + "@LOOP_IN"],
                "LoopVars": snaps,
                "Params": params,
                "Consts": consts,
            },
            outputs={"Out": list(carried)},
            attrs={
                "sub_block": sub.idx,
                "carried_names": list(carried),
                "cond_name": self.cond_var.name,
                "param_names": params,
                "const_names": consts,
                "max_trip_count": int(self.max_trip_count or 0),
            })


# ---------------------------------------------------------------------------
# ConditionalBlock / Switch
# ---------------------------------------------------------------------------

class ConditionalBlock:
    """A sub-block whose writes take effect only when every input cond is
    true (predicated: ``ops/control_flow.py``).  The block communicates by
    assigning into vars that already exist outside it; reads of outer vars
    are captured automatically."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        if not is_scalar_condition:
            raise NotImplementedError(
                "per-row (non-scalar) conditions are served by IfElse "
                "(predicated row merge); ConditionalBlock takes a scalar "
                "predicate")
        for x in inputs:
            if not isinstance(x, Variable):
                raise TypeError("ConditionalBlock inputs must be Variables")
        self.inputs = inputs

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()

        cond = self.inputs[0]
        if len(self.inputs) > 1:
            # all conds must hold: AND-reduce in the parent block
            from . import tensor as tensor_layers
            for extra in self.inputs[1:]:
                cond = tensor_layers.logical_and(cond, extra)

        carried = _written_outer_vars(sub)
        params, consts = _classify_externals(sub, set(carried))
        parent.append_op(
            type="conditional_block",
            inputs={
                "Cond": [cond.name],
                "LoopVars": list(carried),
                "Params": params,
                "Consts": consts,
            },
            outputs={"Out": list(carried)},
            attrs={
                "sub_block": sub.idx,
                "carried_names": list(carried),
                "param_names": params,
                "const_names": consts,
            })


class Switch:
    """``with switch.case(cond):`` chains: each case body takes effect iff
    its cond holds and no earlier case fired (the piecewise-LR
    pattern)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside = False
        self.pre_not_taken = None     # [1] bool: no previous case fired

    def __enter__(self):
        self.inside = True
        return self

    def __exit__(self, *exc):
        self.inside = False
        return False

    def _not(self, v):
        from . import tensor as tensor_layers
        return tensor_layers.logical_not(v)

    def _and(self, a, b):
        from . import tensor as tensor_layers
        return tensor_layers.logical_and(a, b)

    def case(self, condition):
        if not self.inside:
            raise RuntimeError("case() must be used inside 'with Switch()'")
        if self.pre_not_taken is None:
            fire = condition
            self.pre_not_taken = self._not(condition)
        else:
            fire = self._and(self.pre_not_taken, condition)
            self.pre_not_taken = self._and(self.pre_not_taken,
                                           self._not(condition))
        return ConditionalBlock([fire]).block()

    def default(self):
        if self.pre_not_taken is None:
            raise RuntimeError("default() requires at least one case()")
        return ConditionalBlock([self.pre_not_taken]).block()


# ---------------------------------------------------------------------------
# IfElse, predicated
# ---------------------------------------------------------------------------

class IfElse:
    """Row-wise branch select.  Both branches compute on the full batch;
    the outputs are merged row by row with the [B, 1] bool cond
    (``split_lod_tensor`` / ``merge_lod_tensor``)."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.cond = cond
        self._true_outs = []
        self._false_outs = []
        self._cur = None
        self._in_true = False

    @contextlib.contextmanager
    def true_block(self):
        self._cur, self._in_true = self._true_outs, True
        yield
        self._cur = None

    @contextlib.contextmanager
    def false_block(self):
        self._cur, self._in_true = self._false_outs, False
        yield
        self._cur = None

    def input(self, x):
        if self._cur is None:
            raise RuntimeError("input() only valid inside a branch block")
        # predication: the branch sees the full batch
        helper = LayerHelper("ifelse_input")
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(
            type="split_lod_tensor",
            inputs={"X": [x], "Mask": [self.cond.name]},
            outputs={"OutTrue" if self._in_true else "OutFalse": [out],
                     "OutFalse" if self._in_true else "OutTrue":
                         [helper.create_variable_for_type_inference(
                             dtype=x.dtype).name]},
        )
        return out

    def output(self, *outs):
        if self._cur is None:
            raise RuntimeError("output() only valid inside a branch block")
        self._cur.extend(outs)

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError(
                "true_block produced %d outputs, false_block %d"
                % (len(self._true_outs), len(self._false_outs)))
        if not self._true_outs:
            raise ValueError("IfElse produced no outputs")
        helper = LayerHelper("ifelse_merge")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = helper.create_variable_for_type_inference(dtype=t.dtype)
            helper.append_op(
                type="merge_lod_tensor",
                inputs={"Mask": [self.cond.name], "InTrue": [t.name],
                        "InFalse": [f.name]},
                outputs={"Out": [out]},
            )
            merged.append(out)
        return merged if len(merged) > 1 else merged[0]


# ---------------------------------------------------------------------------
# tensor arrays (fixed capacity)
# ---------------------------------------------------------------------------

def create_array(dtype, capacity, element_shape):
    """A [capacity, *element_shape] zero array (arrays have a fixed
    capacity)."""
    from . import tensor as tensor_layers
    return tensor_layers.fill_constant(
        shape=[capacity] + list(element_shape), dtype=dtype, value=0)


def array_write(x, i, array=None, capacity=None):
    """array[i] = x.  Returns the updated array (functional update; inside
    a While block write back to the same var for the loop carry)."""
    helper = LayerHelper("array_write")
    inputs = {"X": [x], "I": [i]}
    attrs = {}
    if array is not None:
        inputs["Array"] = [array]
        out = array           # in-place style: same var carries the value
    else:
        if capacity is None:
            raise ValueError("array_write needs array= or capacity=")
        attrs["capacity"] = int(capacity)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="array_write", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(
        type="array_read", inputs={"Array": [array], "I": [i]},
        outputs={"Out": [out]})
    return out


def array_length(array):
    """Capacity of the array as a [1] int64 tensor."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="lod_array_length", inputs={"X": [array]},
        outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# beam search layers
# ---------------------------------------------------------------------------

def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, name=None):
    """One beam-search step over ``[B, K]`` beams.

    ``scores`` are the step's log-probs ``[B, K, V]``; returns
    (selected_ids [B,K], selected_scores [B,K], parent_idx [B,K]).
    Initialize ``pre_scores`` to ``[0, -inf, ...]`` per row so the first
    expansion is seeded from beam 0 only.
    """
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference(dtype="int64")
    sc = helper.create_variable_for_type_inference(dtype=pre_scores.dtype)
    parent = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="beam_search",
        inputs={"PreIds": [pre_ids], "PreScores": [pre_scores],
                "Scores": [scores]},
        outputs={"SelectedIds": [ids], "SelectedScores": [sc],
                 "ParentIdx": [parent]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return ids, sc, parent


def beam_search_decode(ids, parents, scores, beam_size, end_id, name=None):
    """Backtrack stacked per-step ids/parents ``[T, B, K]`` into full
    sequences ``[B, K, T]`` plus final scores ``[B, K]``."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference(dtype="int64")
    sc = helper.create_variable_for_type_inference(dtype=scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Parents": [parents], "Scores": [scores]},
        outputs={"SentenceIds": [sent], "SentenceScores": [sc]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return sent, sc


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """``input``, printed to standard output on every run (``first_n``
    and ``summarize`` are kept for the API).  An executor entry holding
    it runs eagerly and is never captured (``ops/creation.py``)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="print", inputs={"In": [input]}, outputs={"Out": [out]},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_tensor_lod": print_tensor_lod,
               "print_phase": print_phase.upper(),
               "__var_name__": input.name})
    return out


def is_empty(x, cond=None):
    """A [1] bool: whether ``x`` has no element."""
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


def lod_rank_table(x, level=0):
    """A rank table over ``x``'s sequences: (index, length) rows sorted by
    length, longest first, ties in batch order: a [B, 2] int64 tensor
    read from the @LEN companion.  Only ``level=0`` exists, as padded
    batches carry one nesting level."""
    if level != 0:
        raise NotImplementedError(
            "lod_rank_table: only level=0 exists on the padded+@LEN "
            "design; nested LoD levels are flattened host-side")
    from .sequence import sequence_length
    helper = LayerHelper("lod_rank_table", input=x)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_rank_table",
        inputs={"Length": [sequence_length(x)]},
        outputs={"Out": [out]})
    return out


def max_sequence_len(rank_table):
    """The longest sequence length of a rank table, a 0-d int64
    tensor."""
    helper = LayerHelper("max_sequence_len", input=rank_table)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="max_sequence_len",
        inputs={"RankTable": [rank_table]},
        outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """The batch reordered by a rank table's index column, longest
    sequences first; the output carries the reordered @LEN companion."""
    helper = LayerHelper("reorder_lod_tensor_by_rank", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x], "RankTable": [rank_table]},
        outputs={"Out": [out], "OutLength": [out_len]})
    out._seq_len_name = out_len.name
    return out


def lod_tensor_to_array(x, table):
    """[B, T, ...] batch -> time-major step batches [T, B, ...] in rank
    order (steps stay full width, masked by the lengths)."""
    helper = LayerHelper("lod_tensor_to_array", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_tensor_to_array",
        inputs={"X": [x], "RankTable": [table]},
        outputs={"Out": [out], "OutLength": [out_len]})
    out._seq_len_name = out_len.name
    return out


def array_to_lod_tensor(x, table):
    """The inverse of ``lod_tensor_to_array``."""
    helper = LayerHelper("array_to_lod_tensor", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="array_to_lod_tensor",
        inputs={"X": [x], "RankTable": [table]},
        outputs={"Out": [out], "OutLength": [out_len]})
    out._seq_len_name = out_len.name
    return out
