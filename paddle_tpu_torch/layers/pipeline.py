"""The pipeline region (counterpart of ``paddle_tpu/layers/pipeline.py``):
``Pipeline`` stages a model's repeated blocks so the ``pipeline_region``
op (``ops/pipeline_region.py``) runs them in sequence on one device and
as a pipeline schedule over the ``pp`` axis of a ``ParallelExecutor``
mesh, with the same losses either way.  As ``StaticRNN`` does, it builds
a sub-block from the layer calls made inside each ``with pipe.stage():``
and, when the region closes, appends one op to the enclosing block::

    pipe = Pipeline(microbatches=4)
    for i in range(n_layer):
        with pipe.stage():
            h = pipe.carry(x if i == 0 else None)  # the stage's carry in
            pipe.side(src_len)                     # a per-microbatch side
            h = ...layers on h...                  # the stage's ops
            pipe.emit(h)                           # the stage's carry out
    out = pipe()

Every stage must append the same ops (only their parameters differ),
the carry keeps one shape, and nothing inside a stage may mix rows of
the batch.  The op and its attrs are the JAX package's, so a staged
program serializes alike.
"""

import contextlib

from ..framework import Variable
from ..layer_helper import LayerHelper
from .. import unique_name

__all__ = ["Pipeline"]


class Pipeline:
    def __init__(self, microbatches=None, name=None):
        self.helper = LayerHelper("pipeline", name=name)
        self.microbatches = microbatches
        self.sub_block = None
        self.parent_block = None
        self._stage_bounds = []      # op count at each stage close
        self._carry_init = None      # outer Variable feeding stage 0
        self._carry_in = []          # per-stage in-block placeholder names
        self._carry_out = []         # per-stage carry-out names
        self._sides = []             # outer side Variables (ordered)
        self._in_stage = False
        self._done = False

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def stage(self):
        if self._done:
            raise RuntimeError("pipeline already closed")
        if self._in_stage:
            raise RuntimeError("stages cannot nest")
        program = self.helper.main_program
        if self.sub_block is None:
            self.parent_block = program.current_block()
            self.sub_block = program._create_block()
        else:
            program.current_block_idx = self.sub_block.idx
        self._in_stage = True
        n_before = len(self._carry_in)
        try:
            yield
        finally:
            program.current_block_idx = self.parent_block.idx
            self._in_stage = False
        if len(self._carry_in) != n_before + 1 or \
                len(self._carry_out) != n_before + 1:
            raise ValueError(
                "each stage must call carry() once and emit() once")
        self._stage_bounds.append(len(self.sub_block.ops))

    def carry(self, init=None):
        """Stage's carry-in placeholder.  Stage 0 must pass the outer init
        Variable; later stages chain from the previous stage and must pass
        None (or the same init, for loop-friendly builders)."""
        if not self._in_stage:
            raise RuntimeError("carry() only inside stage()")
        if not self._carry_in:
            if init is None:
                raise ValueError("stage 0 needs carry(init=<outer var>)")
            self._carry_init = init
        elif init is not None and init.name != self._carry_init.name:
            raise ValueError(
                "carry(init=%r) on stage %d: the carry chains from the "
                "previous stage's emit(); only stage 0 takes an init "
                "(got a different var than stage 0's %r)"
                % (init.name, len(self._carry_in), self._carry_init.name))
        ref = self._carry_init
        v = self.sub_block.create_var(
            name=unique_name.generate(ref.name + "@pipe_in"),
            shape=tuple(ref.shape), dtype=ref.dtype)
        self._carry_in.append(v.name)
        return v

    def side(self, var):
        """Register an outer per-batch side input ([B, ...]); each stage
        sees its current microbatch's slice.  Returns the var (ops inside
        the stage reference it by its outer name)."""
        if not isinstance(var, Variable):
            raise TypeError("side() needs a Variable")
        if var.name not in [v.name for v in self._sides]:
            self._sides.append(var)
        return var

    def emit(self, var):
        if not self._in_stage:
            raise RuntimeError("emit() only inside stage()")
        if len(self._carry_out) >= len(self._carry_in):
            raise RuntimeError("emit() already called in this stage")
        if tuple(var.shape) != tuple(self._carry_init.shape):
            raise ValueError(
                "carry shape must stay constant across stages: init %s, "
                "stage %d emits %s" % (tuple(self._carry_init.shape),
                                       len(self._carry_out),
                                       tuple(var.shape)))
        self._carry_out.append(var.name)

    # ------------------------------------------------------------------
    def __call__(self):
        if self._done:
            raise RuntimeError("pipeline already closed")
        if not self._carry_out:
            raise ValueError("pipeline has no stages")
        self._done = True
        from .control_flow import _classify_externals

        stages = len(self._carry_out)
        bound = set(self._carry_in) | {v.name for v in self._sides}
        floats, others = _classify_externals(self.sub_block, bound)
        # persistable floats (parameters) stack per stage; everything else
        # rides the Consts slot replicated
        params, consts = [], list(others)
        for n in floats:
            v = self.sub_block._find_var_recursive(n)
            if v is not None and getattr(v, "persistable", False):
                params.append(n)
            else:
                # a float activation used inside a stage but not declared
                # via side() would ride the (mixed-dtype, undifferentiated,
                # un-microbatched) Consts slot: silent wrong gradients.
                raise ValueError(
                    "float variable %r is read inside a pipeline stage but "
                    "is neither a parameter nor declared with pipe.side(); "
                    "register it as a side input (per-microbatch) or "
                    "compute it inside the stage" % n)

        # float and int sides ride separate slots so the generic vjp can
        # differentiate the float ones (e.g. enc_out feeding a decoder
        # region) — a mixed slot would be skipped wholesale
        f_sides = [v for v in self._sides
                   if v.dtype is not None and v.dtype.is_floating_point]
        i_sides = [v for v in self._sides if v not in f_sides]

        parent = self.parent_block
        out = parent.create_var(
            name=unique_name.generate(self._carry_init.name + "@pipe_out"),
            shape=tuple(self._carry_init.shape),
            dtype=self._carry_init.dtype)
        parent.append_op(
            type="pipeline_region",
            inputs={
                "Carry": [self._carry_init.name],
                "Sides": [v.name for v in f_sides],
                "IntSides": [v.name for v in i_sides],
                "Params": params,
                "Consts": consts,
            },
            outputs={"Out": [out.name]},
            attrs={
                "sub_block": self.sub_block.idx,
                "stages": stages,
                "microbatches": self.microbatches or 0,
                "stage_bounds": list(self._stage_bounds),
                "carry_in_names": list(self._carry_in),
                "carry_out_names": list(self._carry_out),
                "side_names": [v.name for v in f_sides],
                "int_side_names": [v.name for v in i_sides],
                "param_names": params,
                "const_names": consts,
            })
        return out
