"""SpecLayout: canonical parameter shardings + t5x-style logical-axis
rules for the ``(data, fsdp, tp)`` mesh (counterpart of
``paddle_tpu/parallel/spec_layout.py``, whose logic this copies: the same
program gives the same ``PartitionSpec`` a var there and here).

This is the declarative half of the mesh engine (the
``MultiDevSSAGraphBuilder`` analog done the GSPMD way): instead of the
reference's hand-built per-device SSA graph with reduce/broadcast op
handles, each *parameter class* gets a canonical
``PartitionSpec`` — the annotate side of XLA's
annotate-and-propagate sharding in the JAX package.  In the port
``ParallelExecutor``'s plan turns the specs into collectives
(``parallel/plan.py``): a sharded var is held as its shard, gathered
before use, and its gradient reduce-scattered.

Three layers, each usable on its own:

* :class:`SpecLayout` — the table of canonical specs per parameter
  class (embeddings, qkv/ffn projections, norm scales, batch), plus the
  logical-axis rules mapping *model* axes (``vocab``, ``embed``,
  ``mlp``, ``norm``, ``batch``) onto *mesh* axes (``dp``, ``fsdp``,
  ``tp``) — the t5x ``LogicalAxisRules`` pattern.
* :func:`classify_params` / :func:`optimizer_slot_params` — derive each
  persistable var's parameter class from the Program structure (which
  ops consume it), so the rules apply to any layers-DSL model without
  per-model spec tables.  Optimizer slot vars (Adam moments, Momentum
  velocity, ...) inherit their parameter's class; scalar slots
  (beta-pow counters, LR) replicate.
* :meth:`SpecLayout.resolve` — bind the table to a concrete
  (program, mesh, shapes): returns ``{name: PartitionSpec}`` with
  graceful degradation — a mesh axis that is absent or size 1 drops out
  of the spec, a dim a rule does not divide sheds axes until it fits
  (replicating as the last resort), and no mesh axis is used twice in
  one spec.

``BuildStrategy.sharding_rules`` carries a SpecLayout (or ``True`` for
the default one) into ``ParallelExecutor._compile``; the older
``param_sharding_fn`` hook still wins per-param when it returns a spec,
so policies can layer (see strategy.py).
"""

import numpy as np

from .mesh import AXIS_DP, AXIS_FSDP, AXIS_TP
from .mesh import PartitionSpec as P

__all__ = ["SpecLayout", "DEFAULT_RULES", "classify_params",
           "optimizer_slot_params"]


# Logical (model) axes -> mesh axes; tuple values shard one dim over
# several mesh axes (dim size must divide their product).  The t5x
# convention: first matching rule wins, one mesh axis at most once per
# spec.
DEFAULT_RULES = (
    ("batch", (AXIS_DP, AXIS_FSDP)),   # dp AND fsdp both shard the batch
    ("vocab", (AXIS_FSDP, AXIS_TP)),   # embedding rows over fsdp x tp
    ("embed", AXIS_FSDP),              # model dim: ZeRO-sharded
    ("mlp", AXIS_TP),                  # projection out-columns / heads
    ("norm", AXIS_FSDP),               # 1-D scales/biases: ZeRO-sharded
)

# ops that keep their main input's hidden-dim lineage (used by the
# program scan below to tell column-parallel producers from the
# row-parallel consumers that follow them)
_PASSTHROUGH_OPS = {
    "relu", "gelu", "tanh", "sigmoid", "dropout", "scale", "reshape",
    "transpose", "fused_attention", "softmax", "cast",
}


def classify_params(program):
    """Map each parameter to its class as logical dim axes, from the ops
    that consume it:

    * ``lookup_table`` W                     -> ``("vocab", "embed")``
    * ``layer_norm`` Scale/Bias              -> ``("norm",)``
    * ``mul``/``matmul`` weights [in, out]   -> ``("embed", "mlp")``
      (column-parallel), or ``("mlp", "embed")`` (row-parallel) when the
      op's data input descends from a column-parallel output — the
      Megatron pairing: qkv/ffn-up shard columns, attn-out/ffn-down
      shard rows, so the pair needs one all-reduce, not two.
    * 1-D biases added onto a column-parallel output -> ``("mlp",)``;
      other 1-D biases -> ``("norm",)``.

    Returns ``{param_name: tuple_of_logical_axes}``; unlisted
    persistables (counters, tables of odd rank) resolve to replicated.
    """
    classes = {}
    # vars whose LAST dim is currently "mlp"-sharded (output of a
    # column-parallel projection, propagated through elementwise ops)
    mlp_vars = set()
    for blk in program.blocks:
        for op in blk.ops:
            ins, outs = op.inputs, op.outputs
            if op.type == "lookup_table":
                for w in ins.get("W", ()):
                    classes[w] = ("vocab", "embed")
            elif op.type == "layer_norm":
                for slot in ("Scale", "Bias"):
                    for nm in ins.get(slot, ()):
                        classes[nm] = ("norm",)
            elif op.type in ("mul", "matmul"):
                xs = ins.get("X", ())
                for w in ins.get("Y", ()):
                    v = blk._find_var_recursive(w)
                    if v is None or not getattr(v, "persistable", False):
                        continue
                    row_par = any(x in mlp_vars for x in xs)
                    classes.setdefault(
                        w, ("mlp", "embed") if row_par else ("embed", "mlp"))
                    if classes[w] == ("embed", "mlp"):
                        mlp_vars.update(outs.get("Out", ()))
            elif op.type == "elementwise_add":
                xs = ins.get("X", ())
                col = any(x in mlp_vars for x in xs)
                for b in ins.get("Y", ()):
                    v = blk._find_var_recursive(b)
                    if v is not None and getattr(v, "persistable", False) \
                            and v.shape is not None and len(v.shape) == 1:
                        classes.setdefault(b, ("mlp",) if col else ("norm",))
                if col:
                    mlp_vars.update(outs.get("Out", ()))
            elif op.type in _PASSTHROUGH_OPS:
                if any(x in mlp_vars for x in
                       list(ins.get("X", ())) + list(ins.get("Q", ()))):
                    for names in outs.values():
                        mlp_vars.update(names)
    return classes


def optimizer_slot_params(program):
    """Map optimizer slot vars to the parameter they accumulate for, by
    op structure: any op with a ``Param`` input slot (momentum, adam,
    adamax, ...) binds its other persistable inputs — Moment1/Moment2/
    Velocity/beta-pow counters — to that parameter.  Slot vars inherit
    the parameter's sharding when shapes match (resolve() replicates
    the scalar counters)."""
    out = {}
    for blk in program.blocks:
        for op in blk.ops:
            ins = op.inputs
            pnames = ins.get("Param", ())
            if not pnames:
                continue
            for slot, names in ins.items():
                if slot in ("Param", "Grad", "LearningRate"):
                    continue
                for nm in names:
                    v = blk._find_var_recursive(nm)
                    if v is not None and getattr(v, "persistable", False):
                        out.setdefault(nm, pnames[0])
    return out


class SpecLayout:
    """Canonical PartitionSpecs per parameter class on a named
    ``(data, fsdp, tp)`` mesh (SNIPPETS [1] pattern), plus the
    logical->mesh rules and the resolver that binds them to a Program.

    ``rules`` override :data:`DEFAULT_RULES` (same shape: a sequence of
    ``(logical_axis, mesh_axis_or_tuple_or_None)``).  Axis names are
    configurable so the same table drives e.g. a pure-dp ZeRO layout
    (``fsdp_axis="dp"``)."""

    def __init__(self, data_axis=AXIS_DP, fsdp_axis=AXIS_FSDP,
                 tp_axis=AXIS_TP, rules=None):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis
        if rules is None:
            sub = {AXIS_DP: data_axis, AXIS_FSDP: fsdp_axis,
                   AXIS_TP: tp_axis}
            rules = tuple(
                (ln, tuple(sub.get(a, a) for a in m)
                 if isinstance(m, tuple) else sub.get(m, m))
                for ln, m in DEFAULT_RULES)
        self.rules = tuple(rules)
        # first matching rule wins (the t5x convention) — keep the
        # FIRST occurrence of a duplicated logical axis, not dict()'s
        # last-wins
        self._rule_map = {}
        for ln, m in self.rules:
            self._rule_map.setdefault(ln, m)

    # -- the canonical table (documentation + direct use) ---------------
    def batch(self):
        """Feeds/activations: batch dim over data x fsdp."""
        return P((self.data_axis, self.fsdp_axis))

    def embeddings(self):
        """[vocab, embed] tables: rows over fsdp x tp, embed replicated."""
        return P((self.fsdp_axis, self.tp_axis), None)

    def qkv_projection(self):
        """[embed, heads*d_head] attention in-projections: rows fsdp,
        columns tp (column-parallel)."""
        return P(self.fsdp_axis, self.tp_axis)

    def attn_output(self):
        """[heads*d_head, embed] out-projection: rows tp (row-parallel,
        pairing with qkv's column split), columns fsdp."""
        return P(self.tp_axis, self.fsdp_axis)

    def ffn_up(self):
        return P(self.fsdp_axis, self.tp_axis)

    def ffn_down(self):
        return P(self.tp_axis, self.fsdp_axis)

    def norm_scale(self):
        """layer_norm scales/shifts and other 1-D params: ZeRO-sharded
        over fsdp (gathered before its one use)."""
        return P(self.fsdp_axis)

    # -- logical -> mesh resolution -------------------------------------
    def spec_for_logical(self, logical_axes, shape, mesh, rules=None):
        """PartitionSpec for one array: per-dim logical axes through the
        rules (default: this layout's rule map), degraded to whatever
        ``mesh``/``shape`` support."""
        rule_map = self._rule_map if rules is None else rules
        entries, used = [], set()
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        for dim, logical in zip(shape, logical_axes):
            mapped = rule_map.get(logical)
            axes = mapped if isinstance(mapped, tuple) else \
                (mapped,) if mapped else ()
            # keep only live, unused axes; shed from the right until the
            # dim divides the product (replicate the dim as last resort)
            axes = [a for a in axes
                    if sizes.get(a, 1) > 1 and a not in used]
            while axes:
                total = int(np.prod([sizes[a] for a in axes]))
                if dim > 0 and dim % total == 0:
                    break
                axes = axes[:-1]
            if axes:
                used.update(axes)
                entries.append(tuple(axes) if len(axes) > 1 else axes[0])
            else:
                entries.append(None)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    def resolve(self, program, mesh, names_shapes):
        """Bind the table to a concrete (program, mesh): returns
        ``{name: PartitionSpec}`` for every (name, shape) pair.

        Parameter classes come from :func:`classify_params`; optimizer
        slot vars inherit their parameter's class when shapes match and
        replicate otherwise (beta-pow counters); unclassified arrays
        fall back to ZeRO dim-0 fsdp sharding when it divides, else
        replicate."""
        classes = classify_params(program)
        slots = optimizer_slot_params(program)
        fallback_rules = {**self._rule_map, "zero0": self.fsdp_axis}
        out = {}
        for name, shape in names_shapes:
            shape = tuple(shape)
            owner = slots.get(name, name)
            logical = classes.get(owner)
            if logical is not None and owner is not name:
                owner_v = program.global_block()._find_var_recursive(owner)
                owner_shape = tuple(getattr(owner_v, "shape", ()) or ()) \
                    if owner_v is not None else ()
                if len(owner_shape) != len(shape):
                    logical = None      # scalar slot of a tensor param
            if logical is None:
                # ZeRO fallback: shard dim 0 of anything unclassified
                # and non-scalar over fsdp (optimizer state and params
                # alike must not replicate on an fsdp mesh)
                if shape and int(np.prod(shape)) > 1:
                    logical = ("zero0",) + (None,) * (len(shape) - 1)
                else:
                    out[name] = P()
                    continue
            out[name] = self.spec_for_logical(logical, shape, mesh,
                                              rules=fallback_rules)
        return out

    def _identity(self):
        return (self.data_axis, self.fsdp_axis, self.tp_axis, self.rules)

    def __eq__(self, other):
        """Value equality: two default tables are the same policy, so
        executors built with separate ``sharding_rules=True`` strategies
        share one plan (the plan cache keys the layout object)."""
        return isinstance(other, SpecLayout) and \
            self._identity() == other._identity()

    def __hash__(self):
        return hash(self._identity())

    def __repr__(self):
        return "SpecLayout(data=%r, fsdp=%r, tp=%r)" % (
            self.data_axis, self.fsdp_axis, self.tp_axis)
