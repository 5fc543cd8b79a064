"""``StaticRNN``, ``DynamicRNN``, ``Print`` and ``is_empty`` (counterpart
of the recurrent half of ``paddle_tpu/layers/control_flow.py``;
``While``, ``IfElse``, ``Switch``, the tensor arrays and beam search are
still to be ported).

Each builds a sub-block (``Program._create_block``) from the layer calls
made inside ``rnn.step()`` / ``rnn.block()`` and, when the block closes,
appends one ``recurrent`` op to the enclosing block
(``ops/control_flow.py``).  The op lists and attrs are the JAX package's,
so the programs serialize alike.
"""

import contextlib

from .. import unique_name
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["StaticRNN", "DynamicRNN", "Print", "is_empty"]


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
