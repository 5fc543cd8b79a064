"""Operator registry: build-time shape/dtype inference, an eager PyTorch
compute per op, and gradient makers (counterpart of
``paddle_tpu/registry.py``).

An op's compute is a plain function ``compute(ins, attrs, ctx, op_index)``
over tensors, where ``ins`` maps an input slot to a list of tensors.

Gradients follow the JAX package: the default grad maker wires a generic
``<type>_grad`` op that reruns the forward compute and applies the output
cotangents.  Where the JAX package reruns it under ``jax.vjp`` (and XLA
merges the recompute with the forward), the port reruns it eagerly under
``torch.enable_grad()`` and calls ``torch.autograd.grad``: the forward's
work is paid twice, the hand-written kernels' forward launches included.
Ops whose forward draws randomness that the recompute must not re-draw
(``dropout``) register custom grad makers that read saved outputs.

An op registered with ``keep_graph=True`` (the ``recurrent`` op, whose
body may hold a ``dropout``, and the LSTM/GRU family) is not recomputed:
when the run holds its generic grad op, ``compute_op`` runs the forward
under autograd, keeps the graph in ``ctx.saved`` under the forward's op
index, and the grad op pulls the cotangents back through that graph, so
the gradient sees the forward's random draws and the forward's work is
paid once.
"""

import torch

from .core import convert_dtype
from .framework import grad_var_name
from .hash32 import M32, op_seeds

__all__ = ["OpDef", "register_op", "get_op_def", "infer_op", "compute_op",
           "make_grad_ops", "calls_host", "splits_capture", "ComputeContext",
           "OPS", "int_list", "read_inputs", "write_outputs", "optional"]

OPS = {}


class ComputeContext:
    """Per-run context handed to op computes: the device the run executes
    on, the run's random source and ``saved``, where a forward op keeps a
    value for its grad op in the same run, keyed by (the forward's op
    index, a name); the grad op finds it through its ``__fwd_op_index__``
    attr.

    Randomness never passes through a host integer, so a CUDA graph of the
    run draws anew on every replay.  ``generator`` is the executor's
    ``torch.Generator`` for the program's seed (registered with every graph
    that captures the program): ``dropout`` and the random creation ops
    draw from it.  The attention-dropout hash takes ``seed32(op_index)``,
    a device tensor that is a pure function of the run key (one int64 the
    run draws from ``generator`` at its first use) and the op index.

    ``program`` is the program being run (an op that owns a sub-block finds
    it there); ``graph_ops`` holds the indices of the forward ops whose
    generic grad op runs in this run (see ``keep_graph``).  ``shared``
    keeps what several ops of the run compute alike from the same input
    tensors (``shared_value``).  A sub-block's ops run in a context of
    their own (``sub_context``)."""

    def __init__(self, device, generator, n_ops=0, amp=None, program=None,
                 graph_ops=()):
        self.device = device
        self.generator = generator
        self.n_ops = int(n_ops)
        # the program's AMPPolicy (contrib.mixed_precision) or None
        self.amp = amp
        self.program = program
        self.graph_ops = frozenset(graph_ops)
        self.saved = {}
        self.shared = {}
        self.run_key = None
        self._seeds = None
        self._draw_run_key = lambda: torch.randint(
            0, 1 << 62, (1,), device=self.device, generator=self.generator)

    def seed32(self, op_index):
        """The uint32 dropout-hash seed of op ``op_index`` in this run: a
        one-element int32 tensor on the run's device (a view into the
        run's table of every op's seed, made at the first call)."""
        if self.run_key is None:
            self.run_key = self._draw_run_key()
        if self._seeds is None or op_index >= len(self._seeds):
            self._seeds = op_seeds(self.run_key,
                                   max(self.n_ops, op_index + 1))
        return self._seeds[op_index:op_index + 1]

    def shared_value(self, key, tensors, make):
        """``make()``, computed once a run for every op that asks with the
        same ``key`` and the same input ``tensors`` (by identity): what XLA's
        common-subexpression elimination does for the JAX package (the
        paged cache's K and V writes of every layer derive one index plan
        from one page table).  The entry keeps the tensors, so their ids
        are not reused while the run lasts."""
        full = (key,) + tuple(id(t) for t in tensors)
        hit = self.shared.get(full)
        if hit is None or any(a is not b for a, b in zip(hit[0], tensors)):
            hit = self.shared[full] = (tuple(tensors), make())
        return hit[1]

    def sub_context(self, op_index, step):
        """The context of one run of the sub-block of op ``op_index`` (step
        ``step`` of a loop).  It shares the device, generator, AMP policy
        and program, and has a ``saved`` of its own and seeds of its own:
        its run key is op ``op_index``'s seed in the low 32 bits and
        ``step`` in the high ones, so body op i neither reads nor
        overwrites outer op i's saved values or seed, and no two steps
        share a seed."""
        sub = ComputeContext(self.device, self.generator, 0, self.amp,
                             self.program)
        sub._draw_run_key = lambda: (
            (self.seed32(op_index).to(torch.int64) & M32)
            + (int(step) << 32))
        return sub


class OpDef:
    def __init__(self, type, inputs, outputs, infer, compute, grad=None,
                 no_grad_inputs=(), stateful_random=False, keep_graph=False,
                 doc="", calls_host=None, splits_capture=None):
        self.type = type
        self.input_slots = tuple(inputs)
        self.output_slots = tuple(outputs)
        self.infer = infer
        self.compute = compute
        # grad: None => not differentiable; "auto" => generic recompute;
        #       callable(op, no_grad_set) -> list of op-spec dicts
        self.grad = grad
        self.no_grad_inputs = frozenset(no_grad_inputs)
        self.stateful_random = stateful_random
        # the generic grad pulls back through the forward's own autograd
        # graph instead of recomputing it (module docstring)
        self.keep_graph = keep_graph
        # the text ``layers.layer_function_generator`` gives a layer
        self.doc = doc
        # calls_host(attrs) -> True where the op calls back into the host
        # on every run (``print``): its executor entry is never captured
        self.calls_host = calls_host
        # splits_capture(attrs) -> True where the op loops on the host (an
        # unbounded ``while``): the executor runs it between the captured
        # segments of its entry, one body graph replayed a trip
        self.splits_capture = splits_capture


def register_op(type, inputs, outputs, infer, compute, grad="auto",
                no_grad_inputs=(), stateful_random=False, keep_graph=False,
                doc="", calls_host=None, splits_capture=None):
    if type in OPS:
        raise ValueError("op type %r already registered" % type)
    OPS[type] = OpDef(type, inputs, outputs, infer, compute, grad,
                      no_grad_inputs, stateful_random, keep_graph, doc,
                      calls_host, splits_capture)
    return OPS[type]


def get_op_def(type):
    if type not in OPS and type.endswith(GENERIC_GRAD_SUFFIX):
        fwd = OPS.get(type[:-len(GENERIC_GRAD_SUFFIX)])
        if fwd is not None and fwd.grad is not None:
            # the generic grad of a registered op, defined on first use
            OPS[type] = OpDef(type, (), (), infer=_generic_grad_infer,
                              compute=_generic_grad_compute)
    if type not in OPS:
        raise KeyError("op type %r is not ported to paddle_tpu_torch yet"
                       % type)
    return OPS[type]


def calls_host(op):
    """Whether ``op`` calls back into the host when it runs."""
    d = get_op_def(op.type)
    return d.calls_host is not None and bool(d.calls_host(op.attrs))


def splits_capture(op):
    """Whether ``op`` loops on the host, so that the executor splits the
    capture of its entry there."""
    d = get_op_def(op.type)
    return d.splits_capture is not None and bool(d.splits_capture(op.attrs))


def infer_op(op, block):
    """Run build-time shape/dtype inference for ``op`` in ``block``."""
    d = get_op_def(op.type)
    if d.infer is not None:
        d.infer(op, block)


def read_inputs(op, env, ctx):
    """``op``'s inputs from ``env``, slot by slot, cast as the run's AMP
    policy says.

    Empty names are holes (pruned grad slots) and read as None.  The
    ``Out::`` inputs of grad ops are lenient (an optional forward output
    may never have been produced); a ``GRAD::`` input is lenient only when
    its forward output is itself absent, so a missing gradient of a
    produced output stays a loud KeyError."""
    ins = {}
    for slot, names in op.inputs.items():
        if slot.startswith("Out::"):
            ins[slot] = [env.get(n) if n else None for n in names]
        elif slot.startswith("GRAD::"):
            ins[slot] = [_grad_input(env, n) if n else None for n in names]
        else:
            ins[slot] = [env[n] if n else None for n in names]
    if ctx.amp is not None:
        ins = ctx.amp.cast_inputs(op.type, ins)
    return ins


def optional(ins, slot):
    """The tensor of an optional input slot, or None where the op has no
    such input."""
    vals = ins.get(slot)
    return vals[0] if vals and vals[0] is not None else None


def write_outputs(op, env, outs):
    """Bind ``outs`` (slot -> a value or a list) to ``op``'s output
    names in ``env``."""
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            if name:
                env[name] = val
    return env


def compute_op(op, env, ctx, op_index=0):
    """Execute one op: read its inputs from ``env`` (``read_inputs``),
    compute, write its outputs."""
    d = get_op_def(op.type)
    ins = read_inputs(op, env, ctx)
    if d.keep_graph and op_index in ctx.graph_ops:
        outs = _compute_keeping_graph(d, ins, op.attrs, ctx, op_index)
    else:
        outs = d.compute(ins, op.attrs, ctx, op_index)
    return write_outputs(op, env, outs)


_GRAPH = "__graph__"


def _run_with_leaves(fwd_def, primal, attrs, ctx, op_index):
    """The forward computed with its differentiable inputs (floating
    tensors not in ``no_grad_inputs``; a SelectedRows passes through) as
    fresh autograd leaves: (those slots, the inputs with the leaves, the
    outputs)."""
    diff_slots = [slot for slot, vals in primal.items()
                  if slot not in fwd_def.no_grad_inputs and vals
                  and all(isinstance(v, torch.Tensor)
                          and v.is_floating_point() for v in vals)]
    full = dict(primal)
    with torch.enable_grad():
        for slot in diff_slots:
            full[slot] = [v.detach().requires_grad_() for v in primal[slot]]
        outs = fwd_def.compute(full, attrs, ctx, op_index)
    return diff_slots, full, outs


def _compute_keeping_graph(d, ins, attrs, ctx, op_index):
    """Run a ``keep_graph`` forward under autograd and keep the graph for
    its grad op; the run's environment gets detached outputs, so the ops
    after it record nothing."""
    graph = _run_with_leaves(d, ins, attrs, ctx, op_index)
    ctx.saved[(op_index, _GRAPH)] = graph
    return {slot: ([v.detach() if isinstance(v, torch.Tensor) else v
                    for v in vals] if isinstance(vals, (list, tuple))
                   else vals.detach())
            for slot, vals in graph[2].items()}


def _grad_input(env, name):
    fwd = name[:-len("@GRAD")] if name.endswith("@GRAD") else name
    return env.get(name) if fwd not in env else env[name]


# --------------------------------------------------------------------------
# Generic gradient machinery
# --------------------------------------------------------------------------

GENERIC_GRAD_SUFFIX = "_grad"


def make_grad_ops(op, no_grad_set):
    """A list of grad-op specs for a forward op, or [] if none.  A spec is
    a dict(type=..., inputs=..., outputs=..., attrs=...) with variable
    *names*."""
    d = get_op_def(op.type)
    if d.grad is None:
        return []
    if callable(d.grad):
        return d.grad(op, no_grad_set)
    if d.grad == "auto":
        return _auto_grad_maker(op, no_grad_set)
    raise ValueError("bad grad spec for op %r" % op.type)


def _auto_grad_maker(op, no_grad_set):
    """Default grad maker: one ``<type>_grad`` op taking all forward inputs,
    forward outputs and output grads, and producing input grads."""
    d = get_op_def(op.type)
    g_inputs = {slot: list(names) for slot, names in op.inputs.items()}
    for slot, names in op.outputs.items():
        g_inputs["Out::" + slot] = list(names)
        g_inputs["GRAD::" + slot] = [grad_var_name(n) for n in names]
    g_outputs = {}
    any_grad = False
    for slot, names in op.inputs.items():
        if slot in d.no_grad_inputs:
            continue
        outs = []
        for n in names:
            if n in no_grad_set:
                outs.append("")  # hole: grad not needed
            else:
                outs.append(grad_var_name(n))
                any_grad = True
        g_outputs["GRAD::" + slot] = outs
    if not any_grad:
        return []
    attrs = dict(op.attrs)
    attrs["__fwd_type__"] = op.type
    return [dict(type=op.type + GENERIC_GRAD_SUFFIX, inputs=g_inputs,
                 outputs=g_outputs, attrs=attrs)]


def _generic_grad_infer(gop, block):
    """Grad vars mirror the shape/dtype of their forward vars."""
    for slot, fwd_names in gop.inputs.items():
        if slot.startswith(("Out::", "GRAD::")):
            continue
        for fwd_name, g_name in zip(fwd_names,
                                    gop.outputs.get("GRAD::" + slot, [])):
            fwd_var = block._find_var_recursive(fwd_name) if g_name else None
            if fwd_var is not None:
                block.create_var(name=g_name, shape=fwd_var.shape,
                                 dtype=fwd_var.dtype, persistable=False)


def _generic_grad_compute(ins, attrs, ctx, op_index):
    """Rerun the forward with its floating inputs as fresh leaves and pull
    the given output cotangents back through it with autograd (or pull
    them back through the graph a ``keep_graph`` forward kept).  Under AMP
    ``ins`` arrive cast in the forward's colour (``compute_op``), so the
    recompute runs in the forward's dtype and each gradient comes back in
    its leaf's dtype, as ``jax.vjp`` gives it."""
    fwd_def = get_op_def(attrs["__fwd_type__"])
    fwd_attrs = {k: v for k, v in attrs.items()
                 if k not in ("__fwd_type__", "__fwd_op_index__")}
    # a forward that draws randomness (the attention-dropout hash key)
    # must draw the SAME randomness in the recompute: its seed comes
    # from the forward op's index, not the grad op's
    op_index = attrs.get("__fwd_op_index__", op_index)

    graph = ctx.saved.pop((op_index, _GRAPH), None)
    if graph is None:
        primal = {slot: vals for slot, vals in ins.items()
                  if not slot.startswith(("Out::", "GRAD::"))}
        graph = _run_with_leaves(fwd_def, primal, fwd_attrs, ctx, op_index)
    diff_slots, full, outs = graph

    # cotangents: the given GRAD:: inputs, cast to the recomputed output's
    # dtype.  An output with no cotangent has a zero one; it is left out
    # of the autograd call rather than filled with zeros, so a kernel's
    # backward sees None there (the fused loss then skips reading a
    # zero [N, C] softmax cotangent).
    ys, cts = [], []
    for slot in fwd_def.output_slots:
        vals = outs.get(slot)
        if vals is None:
            continue
        vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
        given = ins.get("GRAD::" + slot) or [None] * len(vals)
        for y, g in zip(vals, given):
            if g is None:
                continue
            if not y.requires_grad:
                if bool((g != 0).any()):
                    raise NotImplementedError(
                        "%s: output %r is not differentiable in the port, "
                        "but a nonzero cotangent reached it"
                        % (fwd_def.type, slot))
                continue
            ys.append(y)
            cts.append(g.to(y.dtype))
    leaves = [v for slot in diff_slots for v in full[slot]]
    grads = (torch.autograd.grad(ys, leaves, cts, allow_unused=True)
             if ys else [None] * len(leaves))
    result, it = {}, iter(grads)
    for slot in diff_slots:
        result["GRAD::" + slot] = [
            g if g is not None else torch.zeros_like(v)
            for v, g in zip(full[slot], it)]
    return result


# --------------------------------------------------------------------------
# Shape-inference helpers shared by op definitions
# --------------------------------------------------------------------------

def set_output(op, block, slot, shape, dtype, lod_level=0):
    """Create/refresh the output var for a slot."""
    for name in op.outputs.get(slot, []):
        v = block._find_var_recursive(name)
        if v is None:
            v = block.create_var(name=name)
        v.shape = tuple(int(s) for s in shape) if shape is not None else None
        v.dtype = convert_dtype(dtype) if dtype is not None else None
        v.lod_level = lod_level


def in_var(op, block, slot, idx=0):
    names = op.inputs.get(slot, [])
    if not names:
        return None
    return block._find_var_recursive(names[idx])


def same_shape_infer(in_slot, out_slot):
    def infer(op, block):
        x = in_var(op, block, in_slot)
        set_output(op, block, out_slot, x.shape, x.dtype, x.lod_level)

    return infer


def int_list(v, n):
    """A scalar-or-sequence attr (strides, paddings, ksize) as a list of
    ``n`` values."""
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError("expected %d values, got %r" % (n, list(v)))
        return list(v)
    return [v] * n


def broadcast_shapes(s1, s2):
    """Numpy-style broadcast of shapes with -1 (dynamic) dims propagated."""
    out = []
    for a, b in zip(reversed(s1), reversed(s2)):
        if a == -1 or b == -1:
            out.append(-1 if (a in (-1, 1) and b in (-1, 1)) else max(a, b))
        elif a == 1:
            out.append(b)
        elif b == 1 or a == b:
            out.append(a)
        else:
            raise ValueError("cannot broadcast %s with %s" % (s1, s2))
    longer = s1 if len(s1) > len(s2) else s2
    out.extend(reversed(longer[: abs(len(s1) - len(s2))]))
    return tuple(reversed(out))
