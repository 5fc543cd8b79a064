"""Pass registry and pipelines (counterpart of
``paddle_tpu/transpiler/passes.py``): a pass is a function over a
``Program``, registered by name, so pipelines compose declaratively::

    from paddle_tpu_torch.transpiler import PassBuilder
    pb = PassBuilder()
    pb.append_pass("fuse_conv_bn")
    pb.append_pass("graph_viz", path="g.dot")
    pb.apply(program)

Passes rewrite in place and return a pass-specific result (a match count,
a new program, the dot file's path...); a pass that returns a new
``Program`` feeds it to the passes after it.  ``find_chain`` matches
straight-line producer -> consumer chains, the pattern every shipped
fusion matches.  ``dead_var_eliminate`` and ``const_fold`` are the JAX
package's cleanup passes; ``const_fold`` evaluates constant chains with the
port's own op computes on the CPU (an op type the port lacks fails its
compute and stays in the program, as the JAX pass keeps any unfoldable
op).  An int64 constant folds to int64 here, where the JAX package, with
x64 off, holds it as int32.  The built-in passes are the JAX registry's,
name for name."""

import collections

import torch

from ..framework import Operator, Program
from ..registry import ComputeContext, get_op_def, infer_op

__all__ = ["register_pass", "get_pass", "list_passes", "apply_pass",
           "PassBuilder", "find_chain", "dead_var_eliminate",
           "const_fold"]

_PASSES = {}


def register_pass(name, fn=None, doc=None):
    """Register ``fn`` as a program pass (decorator when fn is None).
    Reference REGISTER_PASS(name, class)."""
    def deco(f):
        if name in _PASSES:
            raise KeyError("pass %r already registered" % name)
        _PASSES[name] = f
        return f

    if fn is not None:
        if doc:
            fn.__doc__ = doc
        return deco(fn)
    return deco


def get_pass(name):
    if name not in _PASSES:
        raise KeyError("unknown pass %r (registered: %s)"
                       % (name, sorted(_PASSES)))
    return _PASSES[name]


def list_passes():
    return sorted(_PASSES)


def apply_pass(program, pass_or_fn, *args, **kwargs):
    """Run one pass (by registered name or as a raw function) over
    ``program``; returns the pass's result."""
    fn = get_pass(pass_or_fn) if isinstance(pass_or_fn, str) \
        else pass_or_fn
    return fn(program, *args, **kwargs)


class PassBuilder:
    """Ordered pass pipeline (reference pass_builder.cc: AppendPass/
    InsertPass/RemovePass then apply in order)."""

    def __init__(self):
        self._pipeline = []   # (name, kwargs)

    def append_pass(self, name, **kwargs):
        get_pass(name)  # fail fast on unknown names
        self._pipeline.append((name, kwargs))
        return self

    def insert_pass(self, idx, name, **kwargs):
        get_pass(name)
        self._pipeline.insert(idx, (name, kwargs))
        return self

    def remove_pass(self, idx):
        self._pipeline.pop(idx)
        return self

    def all_passes(self):
        return [n for n, _ in self._pipeline]

    def apply(self, program):
        """Apply the pipeline in order; returns {pass_name: result}
        (last invocation wins for a repeated pass; the full ordered
        [(name, result)] history is under "__history__").  A pass
        returning a new Program (e.g. inference_optimize) feeds that
        program to the passes after it; the final program is under
        "__program__"."""
        results = {}
        history = []
        current = program
        for name, kwargs in self._pipeline:
            r = apply_pass(current, name, **kwargs)
            results[name] = r
            history.append((name, r))
            if isinstance(r, Program):
                current = r
        results["__program__"] = current
        results["__history__"] = history
        return results


def find_chain(block, op_types):
    """Match straight-line chains ``op_types[0] -> ... -> op_types[-1]``
    where each op's first output feeds the next op's first data input
    and has no other consumer (the fusion-safety condition every
    reference fuse pass checks).  Returns a list of op-index tuples.

    The GraphPatternDetector analog for the chain shapes the shipped
    reference passes match (conv+bn, fc+act, seqconv+pool...).
    """
    ops = block.ops
    consumers = {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names:
            if n:
                consumers.setdefault(n, []).append(i)

    def out0(i):
        for names in ops[i].outputs.values():
            if names:
                return names[0]
        return None

    chains = []
    for start, op in enumerate(ops):
        if op.type != op_types[0]:
            continue
        chain = [start]
        ok = True
        for want in op_types[1:]:
            prev = chain[-1]
            o = out0(prev)
            use = consumers.get(o, [])
            # sole consumer, of the wanted type, fed through an input
            if o is None or len(use) != 1 or ops[use[0]].type != want:
                ok = False
                break
            chain.append(use[0])
        if ok:
            chains.append(tuple(chain))
    return chains


# ---- semantics-preserving cleanup passes ------------------------------------

def _has_sub_block(op):
    # control-flow ops (while/conditional_block/pipeline_region) read
    # vars through their sub-blocks; liveness must treat them as roots
    return "sub_block" in op.attrs


def dead_var_eliminate(program, fetch_names=None):
    """Remove ops and vars that cannot affect ``fetch_names`` or any
    persistable state (reference ``ir/graph.h`` dead-code passes /
    prune.cc, as an in-place cleanup pass).

    Live roots: the fetch set, every op writing a persistable var
    (optimizer updates, running stats), and every op owning a sub-block
    (control flow reads through it).  With ``fetch_names`` omitted the
    pass is conservative — every terminal output counts as live — so it
    only drops unreferenced symbol-table vars.  Returns
    ``{"ops_removed": n, "vars_removed": m}``."""
    block = program.global_block()
    ops = block.ops
    if fetch_names is None:
        consumed = set()
        for op in ops:
            consumed.update(op.input_arg_names)
        fetch = {n for op in ops for n in op.output_arg_names
                 if n and n not in consumed}
    else:
        fetch = {n for n in fetch_names if n}
    live = set(fetch)
    keep = [False] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        root = _has_sub_block(op)
        if not root:
            for n in op.output_arg_names:
                v = block._find_var_recursive(n) if n else None
                if v is not None and v.persistable:
                    root = True
                    break
        if root or (set(op.output_arg_names) & live):
            keep[i] = True
            live.update(n for n in op.input_arg_names if n)
    new_ops = [op for i, op in enumerate(ops) if keep[i]]
    ops_removed = len(ops) - len(new_ops)
    block.ops = new_ops
    used = set(fetch)
    for op in new_ops:
        used.update(op.input_arg_names)
        used.update(op.output_arg_names)
    before = len(block.vars)
    block.vars = collections.OrderedDict(
        (n, v) for n, v in block.vars.items()
        if n in used or v.persistable or v.is_data)
    vars_removed = before - len(block.vars)
    if ops_removed or vars_removed:
        program._version += 1
    return {"ops_removed": ops_removed, "vars_removed": vars_removed}


# ops safe to evaluate at pass time: pure, deterministic, attr-driven
# (no PRNG key, no scope state beyond their const inputs)
_FOLDABLE = {
    "fill_constant", "assign", "assign_value", "scale", "cast",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "sum", "minus", "sign", "clip",
}


def const_fold(program, max_elements=65536):
    """Evaluate compile-time-constant op chains (rooted at
    ``fill_constant``/``assign_value``) once at pass time and replace
    each still-needed result with a single ``assign_value`` op
    (reference ``ir/constant_folding_pass.cc``).  Ops with persistable
    outputs are never folded — they participate in the executor's
    writeback contract — and neither are ops producing more than
    ``max_elements`` values (a folded constant lives as a Python list
    in the op attrs, hashed by every fingerprint and serialized into
    ``__model__``; a giant mask is cheaper as the fill_constant it
    already is).  In place; returns the number of ops folded away."""
    block = program.global_block()
    ctx = ComputeContext(torch.device("cpu"), None, len(block.ops),
                         program=program)
    # a name written MORE THAN ONCE is never a constant: a later
    # non-folded writer would rebind it, and folding consumers against
    # the first write's value miscompiles (name-keyed map, no SSA)
    write_counts = {}
    for op in block.ops:
        for n in op.output_arg_names:
            if n:
                write_counts[n] = write_counts.get(n, 0) + 1
    rebound = {n for n, c in write_counts.items() if c > 1}
    known = {}
    folded = set()
    for i, op in enumerate(block.ops):
        if op.type not in _FOLDABLE:
            continue
        if any(n in rebound for n in op.output_arg_names):
            continue
        names = [n for ns in op.inputs.values() for n in ns if n]
        if any(n not in known for n in names):
            continue
        skip = False
        for n in op.output_arg_names:
            v = block._find_var_recursive(n) if n else None
            if v is not None and v.persistable:
                skip = True
            if v is not None and v.shape is not None:
                size = 1
                for s in v.shape:
                    size *= max(1, int(s))
                if size > int(max_elements):
                    skip = True
        if skip:
            continue
        ins = {slot: [known.get(n) if n else None for n in ns]
               for slot, ns in op.inputs.items()}
        try:
            with torch.no_grad():
                outs = get_op_def(op.type).compute(ins, op.attrs, ctx, i)
        except Exception:  # noqa: BLE001 — an op type the port lacks or an
            continue       # unfoldable corner stays in the program
        for slot, onames in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for nm, v in zip(onames, vals):
                if nm:
                    known[nm] = torch.as_tensor(v).detach().cpu()
        folded.add(i)
    if not folded:
        return 0
    # folded values still consumed by surviving ops (or terminal in the
    # program — a fetchable result) materialize as one assign_value
    all_consumed = set()
    needed = set()
    for i, op in enumerate(block.ops):
        all_consumed.update(op.input_arg_names)
        if i not in folded:
            needed.update(n for n in op.input_arg_names if n in known)
    for i in folded:
        for nm in block.ops[i].output_arg_names:
            if nm and nm not in all_consumed:
                needed.add(nm)      # terminal constant: keep fetchable
    new_ops = []
    materialized = set()
    for i, op in enumerate(block.ops):
        if i not in folded:
            new_ops.append(op)
            continue
        for nm in op.output_arg_names:
            if nm in needed and nm not in materialized:
                v = known[nm].numpy()
                a = Operator(
                    block, type="assign_value", inputs={},
                    outputs={"Out": [nm]},
                    attrs={"shape": [int(s) for s in v.shape],
                           "dtype": str(v.dtype),
                           "values": v.ravel().tolist()})
                infer_op(a, block)
                new_ops.append(a)
                materialized.add(nm)
    block.ops = new_ops
    program._version += 1
    return len(folded)


# ---- built-in registrations ------------------------------------------------

def _register_builtins():
    from ..debugger import draw_block_graphviz
    from .fusion import fuse_conv_bn
    from .inference_transpiler import InferenceTranspiler
    from .memory_optimization_transpiler import memory_optimize

    register_pass("fuse_conv_bn", fuse_conv_bn)
    register_pass("memory_optimize", memory_optimize)
    register_pass("dead_var_eliminate", dead_var_eliminate)
    register_pass("const_fold", const_fold)

    @register_pass("quantize_inference")
    def _quantize_inference(program, scope=None, mode="weight_only",
                            weight_bits=8):
        """int8 program rewrite (quantize_pass.quantize_inference):
        returns the NEW quantized program (chained by PassBuilder)."""
        from .quantize_pass import quantize_inference

        return quantize_inference(program, scope=scope, mode=mode,
                                  weight_bits=weight_bits)

    @register_pass("inference_optimize")
    def _inference_optimize(program, place=None, scope=None):
        """clone(for_test) + frozen-BN folding; returns the NEW
        program (InferenceTranspiler as a pass)."""
        return InferenceTranspiler().transpile(program, place, scope)

    @register_pass("bfloat16")
    def _bfloat16(program, place=None, scope=None, fetch_targets=None):
        """contrib.float16's bf16 inference rewrite as a pass."""
        from ..contrib.float16 import Bfloat16Transpiler

        return Bfloat16Transpiler().transpile(
            program, place, scope=scope, fetch_targets=fetch_targets)

    @register_pass("graph_viz")
    def _graph_viz(program, path="./temp.dot", render=False):
        """Dump the program graph as graphviz dot; returns the written
        path."""
        return draw_block_graphviz(program.global_block(), path=path,
                                   render=render)


_register_builtins()
