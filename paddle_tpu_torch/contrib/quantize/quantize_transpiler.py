"""Quantization-aware-training program rewrite (counterpart of
``paddle_tpu/contrib/quantize/quantize_transpiler.py``).

``training_transpile`` puts a fake quant-dequant op on every float input
of every quantizable op (``conv2d``, ``depthwise_conv2d``, ``mul``,
``matmul``) so that training sees the int8 grid's rounding.  It runs
BEFORE ``append_backward``, as in the JAX package: the gradients are
derived from the rewritten forward, so the fake-quant ops'
straight-through gradients (``ops/quantize.py``) need no rewiring of grad
ops.  ``abs_max`` takes each tensor's current abs-max as its scale
(per channel for weights with ``weight_quant_axis``); ``range_abs_max``
keeps a running scale as a persistable variable, zero from the startup
program, which the op's ``OutScale`` writes back under the same name in
every step (a captured step too: the executor copies a persistable output
into its state tensor at the end of the graph).

``freeze_program`` is ``clone(for_test=True)``, where ``range_abs_max``
uses its trained scale as it is; ``convert_to_int8`` stores every
quantized weight as int8 with its scale in the scope.  The program, the
variables and the scales are the JAX package's."""

import numpy as np
import torch

from ...core import dtype_name
from ...framework import (Operator, Parameter, default_main_program,
                          default_startup_program)
from ...registry import infer_op
from ...scope import global_scope

__all__ = ["QuantizeTranspiler"]

_QUANTIZABLE_OP_TYPES = ("conv2d", "depthwise_conv2d", "mul", "matmul")
_QUANT_TYPES = ("abs_max", "range_abs_max")


class QuantizeTranspiler:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 weight_quant_axis=None):
        if weight_quantize_type not in _QUANT_TYPES:
            raise ValueError(
                "Unknown weight_quantize_type: %r" % weight_quantize_type)
        if activation_quantize_type not in _QUANT_TYPES:
            raise ValueError(
                "Unknown activation_quantize_type: %r"
                % activation_quantize_type)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.window_size = window_size   # accepted for the API
        # per-channel weight grids: "auto" takes the consumer's output-
        # channel axis (conv filters 0, mul/matmul weights their last), an
        # int pins the axis, None keeps one scale a tensor.  abs_max
        # weights only: the range_abs_max running scale is one value.
        if weight_quant_axis not in (None, "auto") and \
                not isinstance(weight_quant_axis, int):
            raise ValueError(
                "weight_quant_axis must be None, 'auto', or an int, "
                "got %r" % (weight_quant_axis,))
        self.weight_quant_axis = weight_quant_axis

    def training_transpile(self, program=None, startup_program=None):
        """Insert fake quant-dequant ops on every input of every
        quantizable op, in every block.  Must run before
        ``append_backward`` / ``minimize``.  Returns the number of
        fake-quant ops inserted."""
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        for blk in program.blocks:
            if any(op.type.endswith("_grad") for op in blk.ops):
                raise ValueError(
                    "training_transpile must run BEFORE append_backward: "
                    "gradients are derived from the rewritten forward")

        params = {p.name
                  for p in program.global_block().all_parameters()}
        inserted = 0
        for block in program.blocks:
            quantized = {}   # var name -> fake-quantized var name
            new_ops = []
            for op in block.ops:
                if op.type in _QUANTIZABLE_OP_TYPES:
                    for slot, names in list(op.inputs.items()):
                        renamed = []
                        for name in names:
                            var = block._find_var_recursive(name)
                            if var is None or var.dtype is None or \
                                    "float" not in dtype_name(var.dtype):
                                renamed.append(name)
                                continue
                            if name not in quantized:
                                qname, qops = self._make_quant_ops(
                                    block, startup, name, name in params,
                                    consumer_type=op.type)
                                new_ops.extend(qops)
                                inserted += len(qops)
                                quantized[name] = qname
                            renamed.append(quantized[name])
                        op.inputs[slot] = renamed
                new_ops.append(op)
            block.ops = new_ops
        program._version += 1
        return inserted

    def _quant_axis_for(self, var, consumer_type):
        """The per-channel axis for a weight feeding ``consumer_type``
        (None: one scale for the tensor)."""
        axis = self.weight_quant_axis
        if axis is None:
            return None
        if axis == "auto":
            if consumer_type in ("conv2d", "depthwise_conv2d"):
                return 0        # [O, C, H, W] filters: output channel
            return len(var.shape) - 1   # mul/matmul [K, N]: output axis
        # a negative axis would read as per-tensor in the op's attr
        return int(axis) % len(var.shape)

    def _make_quant_ops(self, block, startup, name, is_weight,
                        consumer_type=None):
        bits = self.weight_bits if is_weight else self.activation_bits
        qtype = self.weight_quantize_type if is_weight \
            else self.activation_quantize_type
        var = block._find_var_recursive(name)
        qname = name + ".quantized.dequantized"
        scale_name = name + ".scale"
        block.create_var(name=qname, shape=var.shape, dtype=var.dtype,
                         persistable=False)
        if qtype == "abs_max":
            attrs = {"bit_length": bits}
            scale_shape = (1,)
            if is_weight:
                axis = self._quant_axis_for(var, consumer_type)
                if axis is not None:
                    attrs["quant_axis"] = axis
                    scale_shape = (var.shape[axis],)
            block.create_var(name=scale_name, shape=scale_shape,
                             dtype=var.dtype, persistable=False)
            op = Operator(block, type="fake_quantize_abs_max",
                          inputs={"X": [name]},
                          outputs={"Out": [qname],
                                   "OutScale": [scale_name]},
                          attrs=attrs)
        else:
            # the running scale: persistable, 0 from the startup program,
            # OutScale written back over InScale every step
            block.create_var(name=scale_name, shape=(1,), dtype=var.dtype,
                             persistable=True)
            sblock = startup.global_block()
            sblock.create_var(name=scale_name, shape=(1,),
                              dtype=var.dtype, persistable=True)
            init = Operator(sblock, type="fill_constant", inputs={},
                            outputs={"Out": [scale_name]},
                            attrs={"shape": [1], "value": 0.0,
                                   "dtype": dtype_name(var.dtype),
                                   "force_cpu": False})
            infer_op(init, sblock)
            sblock.ops.append(init)
            startup._version += 1
            op = Operator(block, type="fake_quantize_range_abs_max",
                          inputs={"X": [name], "InScale": [scale_name]},
                          outputs={"Out": [qname],
                                   "OutScale": [scale_name]},
                          attrs={"bit_length": bits})
        infer_op(op, block)
        return qname, [op]

    def freeze_program(self, program, place=None, fuse_bn=False,
                       scope=None):
        """The inference version of a quantize-transpiled program:
        ``clone(for_test=True)`` turns the fake-quant ops to test mode,
        where ``range_abs_max`` takes its trained running scale as it is.
        ``fuse_bn`` (folding frozen batch norms, the JAX package's
        ``InferenceTranspiler``) is not ported and raises."""
        if fuse_bn:
            raise NotImplementedError(
                "freeze_program(fuse_bn=True) needs InferenceTranspiler, "
                "which is not ported to paddle_tpu_torch yet (ROADMAP "
                "Queue A8)")
        return program.clone(for_test=True)

    def convert_to_int8(self, program, place=None, scope=None):
        """Store every quantized weight as int8 in the scope
        (``<name>.int8`` and ``<name>.int8_scale``, on the weight's
        device); returns {weight name: (int8 name, scale)}."""
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        rng = float((1 << (self.weight_bits - 1)) - 1)
        out = {}
        for op in block.ops:
            if op.type not in ("fake_quantize_abs_max",
                               "fake_quantize_range_abs_max"):
                continue
            name = op.inputs["X"][0]
            var = block._find_var_recursive(name)
            if not isinstance(var, Parameter) or not scope.has_var(name):
                continue
            tensor = scope.var(name)
            w = tensor.detach().cpu().double().numpy()
            axis = op.attrs.get("quant_axis", -1)
            if op.type == "fake_quantize_range_abs_max" and \
                    scope.has_var(op.inputs["InScale"][0]):
                # the trained running scale is the grid QAT trained on
                scale = max(float(scope.var(op.inputs["InScale"][0])
                                  .detach().cpu().reshape(-1)[0]), 1e-12)
            elif axis is not None and axis >= 0:
                red = tuple(i for i in range(w.ndim) if i != axis)
                scale = np.maximum(np.max(np.abs(w), axis=red), 1e-12)
            else:
                scale = max(float(np.max(np.abs(w))), 1e-12)
            bshape = [1] * w.ndim
            if np.ndim(scale):
                bshape[axis] = -1
            q = np.clip(np.round(w / np.reshape(scale, bshape) * rng),
                        -rng, rng).astype(np.int8)
            scope.set_var(name + ".int8",
                          torch.from_numpy(q).to(tensor.device))
            scope.set_var(name + ".int8_scale", torch.from_numpy(
                np.asarray(scale, np.float32).reshape(-1)).to(tensor.device))
            out[name] = (name + ".int8", scale)
        return out
