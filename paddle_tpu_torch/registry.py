"""Operator registry: build-time shape/dtype inference plus an eager
PyTorch compute per op (counterpart of ``paddle_tpu/registry.py``).

An op's compute is a plain function ``compute(ins, attrs, ctx, op_index)``
over tensors, where ``ins`` maps an input slot to a list of tensors.  The
serving slice is forward-only: the grad makers of the JAX package come
with the training slice.
"""

import numpy as np
import torch

from .core import convert_dtype

__all__ = ["OpDef", "register_op", "get_op_def", "infer_op", "compute_op",
           "ComputeContext", "OPS"]

OPS = {}


class ComputeContext:
    """Per-run context handed to op computes: the device the run executes
    on and the seed material for ops that draw random numbers."""

    def __init__(self, device, seed=0, run_index=0):
        self.device = device
        self.seed = int(seed)
        self.run_index = int(run_index)

    def _entropy(self, op_index):
        return np.random.SeedSequence(
            [self.seed, self.run_index, int(op_index)])

    def seed32(self, op_index):
        """A uint32 seed for op ``op_index`` of this run (the dropout hash
        key), reproducible from (program seed, run index, op index)."""
        return int(self._entropy(op_index).generate_state(1, np.uint32)[0])

    def generator(self, op_index):
        """A ``torch.Generator`` on the run's device for op ``op_index``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self._entropy(op_index).generate_state(
            1, np.uint64)[0] >> np.uint64(1)))
        return g


class OpDef:
    def __init__(self, type, inputs, outputs, infer, compute):
        self.type = type
        self.input_slots = tuple(inputs)
        self.output_slots = tuple(outputs)
        self.infer = infer
        self.compute = compute


def register_op(type, inputs, outputs, infer, compute):
    if type in OPS:
        raise ValueError("op type %r already registered" % type)
    OPS[type] = OpDef(type, inputs, outputs, infer, compute)
    return OPS[type]


def get_op_def(type):
    if type not in OPS:
        raise KeyError("op type %r is not ported to paddle_tpu_torch yet"
                       % type)
    return OPS[type]


def infer_op(op, block):
    """Run build-time shape/dtype inference for ``op`` in ``block``."""
    get_op_def(op.type).infer(op, block)


def compute_op(op, env, ctx, op_index=0):
    """Execute one op: read its inputs from ``env``, write its outputs."""
    d = get_op_def(op.type)
    ins = {slot: [env[n] if n else None for n in names]
           for slot, names in op.inputs.items()}
    outs = d.compute(ins, op.attrs, ctx, op_index)
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
