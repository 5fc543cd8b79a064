"""Program-graph IR: Program / Block / Operator / Variable / Parameter.

Counterpart of ``paddle_tpu/framework.py``.  The Python objects are the
IR; shape/dtype inference runs at ``append_op`` time through the op
registry, and programs serialize to the same plain-dict schema as the JAX
package (``Program.to_dict`` / ``to_json`` / ``from_dict``), with dtypes
written by name, so a program built by either package serializes to the
same JSON and loads in the other.  The executor runs the global block; a
sub-block (``_create_block``, made by ``StaticRNN`` / ``DynamicRNN``) is
run by the op that owns it (``recurrent``, ``ops/control_flow.py``).
Gradients are ordinary variables named ``<var>@GRAD``
(``grad_var_name``), appended by ``backward.append_backward``.
"""

import collections
import contextlib
import copy
import json

import numpy as np
import torch

from . import unique_name
from .core import VarType, convert_dtype, dtype_name

__all__ = [
    "Program",
    "Block",
    "Operator",
    "Variable",
    "Parameter",
    "default_startup_program",
    "default_main_program",
    "program_guard",
    "grad_var_name",
    "GRAD_VAR_SUFFIX",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(var_name):
    """Name of the gradient variable of ``var_name``."""
    return var_name + GRAD_VAR_SUFFIX


class Variable:
    """A typed symbol in a Block.  Storage lives in a ``Scope``; a Variable
    is only the build-time description: shape (-1 for dynamic dims),
    ``torch.dtype``, persistable, lod_level (padded-sequence marker)."""

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype=None,
        type=VarType.DENSE_TENSOR,
        persistable=False,
        stop_gradient=False,
        is_data=False,
        lod_level=0,
        initializer=None,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        self.initializer = initializer
        self.op = None
        # clip applied to this var's gradient as backward sums it
        # (clip.ErrorClipByValue)
        self.error_clip = kwargs.get("error_clip", None)
        # name of the companion [batch] int32 length var of a padded
        # sequence ("<name>@LEN", see layers.data)
        self._seq_len_name = None

    def astype_desc(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": dtype_name(self.dtype) if self.dtype is not None else None,
            "type": self.type,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "lod_level": self.lod_level,
        }

    def astype(self, dtype):
        """This variable cast to ``dtype`` by a ``cast`` op."""
        from .layers.tensor import cast  # local import to avoid a cycle

        return cast(self, dtype)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape,
            dtype_name(self.dtype) if self.dtype is not None else None,
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """A persistable, trainable Variable, with the optimizer's per-parameter
    settings (learning-rate multiplier, regularizer, gradient clip)."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter must have shape and dtype")
        for s in shape:
            if s <= 0:
                raise ValueError("each dim of Parameter must be > 0, got %s" % (shape,))
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)

    def __repr__(self):
        return "Parameter(name=%s, shape=%s, dtype=%s)" % (
            self.name, self.shape, dtype_name(self.dtype))

    __str__ = __repr__


class Operator:
    """One node of the program graph: slot name -> list of variable names,
    plus a dict of JSON-able attrs.  Appending runs shape inference."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.attrs = dict(attrs) if attrs else {}

        def _canon(mapping):
            out = collections.OrderedDict()
            for slot, vs in (mapping or {}).items():
                if vs is None:
                    out[slot] = []
                    continue
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                out[slot] = [v.name if isinstance(v, Variable) else v for v in vs]
            return out

        self.inputs = _canon(inputs)
        self.outputs = _canon(outputs)

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (
            self.type,
            ", ".join("%s=%s" % kv for kv in self.inputs.items()),
            ", ".join("%s=%s" % kv for kv in self.outputs.items()),
        )

    __str__ = __repr__


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, torch.dtype):
            v = dtype_name(v)
        elif isinstance(v, np.dtype):
            v = str(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        out[k] = v
    return out


class Block:
    """An ordered list of Operators plus a symbol table of Variables."""

    def __init__(self, program, idx, parent_idx=-1, forward_block_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = forward_block_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get("name", None)
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        # parameters always live in the global block
        global_block = self.program.global_block()
        param = Parameter(global_block, **kwargs)
        global_block.vars[param.name] = param
        return param

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        return self._find_var_recursive(name) is not None

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("var %r does not exist in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def var_recursive(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("var %r not found in block %d or ancestors"
                             % (name, self.idx))
        return v

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self._infer_and_mark(op)
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self._infer_and_mark(op)
        return op

    def _infer_and_mark(self, op):
        from .registry import infer_op  # local import to avoid a cycle

        self.program._version += 1
        infer_op(op, self)
        # outputs inherit the first input's sequence-length companion
        seq_len = None
        for name in op.input_arg_names:
            v = self._find_var_recursive(name) if name else None
            if v is not None and v._seq_len_name:
                seq_len = v._seq_len_name
                break
        for name in op.output_arg_names:
            v = self._find_var_recursive(name)
            if v is not None:
                v.op = op
                if seq_len and not v._seq_len_name:
                    v._seq_len_name = seq_len

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.astype_desc() | {"is_parameter": isinstance(v, Parameter)}
                     for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = ["Block(%d):" % self.idx]
        lines += ["  " + repr(v) for v in self.vars.values()]
        lines += ["  " + repr(op) for op in self.ops]
        return "\n".join(lines)

    __str__ = __repr__


class Program:
    """A whole computation: nested blocks, block 0 is global."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        # bumped on every structural change (the executor's analysis cache)
        self._version = 0
        # the bfloat16 mixed-precision policy (contrib.mixed_precision);
        # set without a version bump, so the executor keys on it as well
        self._amp_policy = None

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None, forward_block_idx=-1):
        """Append a block under ``parent_idx`` (default: the current
        block) and make it current."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent_idx=parent,
                                 forward_block_idx=forward_block_idx))
        self.current_block_idx = new_idx
        return self.current_block()

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test=False):
        """Deep-copy the program.  ``for_test=True`` switches the ops that
        behave differently in training to inference mode (``is_test``)."""
        p = copy.deepcopy(self)
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                        op.attrs["is_test"] = True
        return p

    def prune_feed_fetch(self, feed_names, fetch_names):
        """A copy that keeps only the ops needed to compute ``fetch_names``
        from ``feed_names``, and only the variables those ops, the feeds and
        the fetches name."""
        p = copy.deepcopy(self)
        blk = p.global_block()
        needed = set(fetch_names)
        kept = []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed:
                kept.append(op)
                needed.update(op.input_arg_names)
        blk.ops = list(reversed(kept))
        used = set(feed_names) | set(fetch_names)
        for op in blk.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        blk.vars = collections.OrderedDict(
            (n, v) for n, v in blk.vars.items() if n in used)
        return p

    def to_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd.get("parent_idx", -1),
                        bd.get("forward_block_idx", -1))
            for vd in bd["vars"]:
                kwargs = dict(
                    name=vd["name"],
                    type=vd.get("type", VarType.DENSE_TENSOR),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    is_data=vd.get("is_data", False),
                    lod_level=vd.get("lod_level", 0),
                )
                if vd.get("is_parameter"):
                    v = Parameter(blk, vd["shape"], vd["dtype"], **kwargs)
                else:
                    v = Variable(blk, shape=vd["shape"], dtype=vd["dtype"], **kwargs)
                blk.vars[v.name] = v
            for od in bd["ops"]:
                blk.ops.append(Operator(blk, od["type"], od["inputs"],
                                        od["outputs"], od["attrs"]))
            p.blocks.append(blk)
        p.current_block_idx = 0
        return p

    @staticmethod
    def from_json(s):
        return Program.from_dict(json.loads(s))

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


# ops whose ``is_test`` attr ``clone(for_test=True)`` sets: dropout and
# batch_norm switch to inference; the range fake-quant reads its trained
# running scale instead of updating it
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "fake_quantize_range_abs_max": ("is_test",),
}

_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Route subsequent layer calls into the given programs."""
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
