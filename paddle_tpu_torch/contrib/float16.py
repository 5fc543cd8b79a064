"""The bfloat16 inference rewrite (counterpart of
``paddle_tpu/contrib/float16.py``): a trained float32 inference program
and its scope are rewritten to compute in bfloat16 while the caller still
feeds and fetches float32.  Only the boundaries change:

1. the float32 parameters in the scope are cast to bfloat16 in place and
   their program variables retyped;
2. a ``cast`` op to bfloat16 goes in after each float32 feed that an op
   reads, and the readers take its ``@BF16`` twin;
3. the black-listed ops (the AMP black list less the training-only ops)
   read float32 through a ``cast`` to an ``@FP32`` twin;
4. a convolution whose input is float32 (a black-listed op's output,
   such as AlexNet's ``lrn``) reads it through a ``cast`` to bfloat16,
   steps 3 and 4 repeating until nothing changes.  The JAX package
   leaves that input float32, where ``lax.conv_general_dilated`` refuses
   a bfloat16 filter; the port differs from its rewrite only there;
5. each bfloat16 fetch target's producer writes a ``@BF16`` twin, and a
   ``cast`` back to float32 writes the fetch name, so fetch dtypes stay
   float32.
"""

import torch

from ..framework import Program
from ..registry import infer_op
from ..scope import global_scope
from .mixed_precision import AutoMixedPrecisionLists, cast_parameters_to_bf16

__all__ = ["Bfloat16Transpiler", "Float16Transpiler"]

# the optimizer updates and the gradient machinery never appear in an
# inference program; there ``sum`` adds residuals and stays in bfloat16
_TRAIN_ONLY = {
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
    "rmsprop", "ftrl", "decayed_adagrad", "proximal_gd",
    "proximal_adagrad", "sum", "clip_by_norm", "squared_l2_norm",
    "isfinite",
}
_FP32_OPS = set(AutoMixedPrecisionLists.BLACK) - _TRAIN_ONLY

_SKIP_RENAME = {"cast", "feed", "fetch"}

_CONV_OPS = {"conv2d", "depthwise_conv2d"}


class Bfloat16Transpiler:
    """Rewrite an inference program and its scope for bfloat16."""

    def transpile(self, program, place=None, scope=None, fetch_targets=None):
        """``fetch_targets``: the Variables or names whose fetched dtype
        must stay float32 (``load_inference_model``'s fetch vars)."""
        if not isinstance(program, Program):
            raise TypeError("program should be a Program")
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        self._input_map = {}
        self._convert_params(block, scope)
        self._cast_feeds(block)
        self._adjust_inputs(block)
        self._repropagate(block)
        self._guard_fp32_ops(block)
        self._repropagate(block)
        while self._cast_conv_inputs(block):
            self._repropagate(block)
            self._guard_fp32_ops(block)
            self._repropagate(block)
        self._cast_fetches(block, fetch_targets or [])
        self._repropagate(block)
        return program

    @staticmethod
    def _repropagate(block):
        """Rerun shape/dtype inference in op order, so the variables'
        dtypes follow the rewritten boundaries."""
        for op in block.ops:
            infer_op(op, block)

    def _convert_params(self, block, scope):
        cast_parameters_to_bf16(block.program, scope)
        for var in list(block.vars.values()):
            if var.persistable and var.dtype == torch.float32 \
                    and scope.find_var(var.name) is not None:
                var.dtype = torch.bfloat16

    def _cast_feeds(self, block):
        # only the data vars some op reads: a pruned program keeps orphan
        # feed vars, and a cast of one would make it a required input
        consumed = set()
        for op in block.ops:
            consumed.update(op.input_arg_names)
        idx = 0
        for var in list(block.vars.values()):
            if not var.is_data or var.name not in consumed \
                    or var.dtype != torch.float32:
                continue
            twin_name = var.name + "@BF16"
            twin = block.create_var(name=twin_name, shape=var.shape,
                                    dtype="bfloat16", stop_gradient=True)
            if var._seq_len_name:
                twin._seq_len_name = var._seq_len_name
            block.insert_op(idx, type="cast", inputs={"X": [var.name]},
                            outputs={"Out": [twin_name]},
                            attrs={"out_dtype": "bfloat16"})
            idx += 1
            self._input_map[var.name] = twin_name

    def _adjust_inputs(self, block):
        """Point the readers of each cast feed at its twin."""
        for op in block.ops:
            if op.type in _SKIP_RENAME:
                continue
            for slot, names in op.inputs.items():
                op.inputs[slot] = [self._input_map.get(n, n) for n in names]

    def _guard_fp32_ops(self, block):
        """A cast to float32 before each bfloat16 input of a black-listed
        op; its outputs then infer float32."""
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type in _FP32_OPS:
                for slot, names in list(op.inputs.items()):
                    new_names = []
                    for n in names:
                        v = block._find_var_recursive(n)
                        if v is None or v.dtype != torch.bfloat16:
                            new_names.append(n)
                            continue
                        cast_name = n + "@FP32"
                        if block._find_var_recursive(cast_name) is None:
                            block.create_var(name=cast_name, shape=v.shape,
                                             dtype="float32",
                                             stop_gradient=True)
                            block.insert_op(i, type="cast", inputs={"X": [n]},
                                            outputs={"Out": [cast_name]},
                                            attrs={"out_dtype": "float32"})
                            i += 1
                        new_names.append(cast_name)
                    op.inputs[slot] = new_names
            i += 1

    def _cast_conv_inputs(self, block):
        """A cast to bfloat16 before each float32 input of a convolution
        whose filter is bfloat16 (a black-listed op's output, such as
        ``lrn``'s in AlexNet): the JAX package leaves it float32, and its
        convolution refuses operands of two dtypes.  Returns the number
        of casts inserted."""
        n, i = 0, 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type in _CONV_OPS:
                x = block._find_var_recursive(op.inputs["Input"][0])
                w = block._find_var_recursive(op.inputs["Filter"][0])
                if x.dtype == torch.float32 and w.dtype == torch.bfloat16:
                    cast_name = x.name + "@BF16"
                    if block._find_var_recursive(cast_name) is None:
                        block.create_var(name=cast_name, shape=x.shape,
                                         dtype="bfloat16",
                                         stop_gradient=True)
                        block.insert_op(i, type="cast",
                                        inputs={"X": [x.name]},
                                        outputs={"Out": [cast_name]},
                                        attrs={"out_dtype": "bfloat16"})
                        i += 1
                    op.inputs["Input"] = [cast_name]
                    n += 1
            i += 1
        return n

    def _cast_fetches(self, block, fetch_targets):
        for t in fetch_targets:
            name = t if isinstance(t, str) else t.name
            var = block._find_var_recursive(name)
            if var is None:
                raise KeyError("fetch target %r not in program" % name)
            if var.dtype == torch.float32:
                continue  # already float32 (a guarded softmax's output)
            producer = None
            for op in block.ops:
                if name in op.output_arg_names:
                    producer = op
            if producer is None or producer.type == "cast":
                continue
            twin_name = name + "@BF16"
            block.create_var(name=twin_name, shape=var.shape,
                             dtype="bfloat16", stop_gradient=True)
            for slot, names in producer.outputs.items():
                producer.outputs[slot] = [
                    twin_name if n == name else n for n in names]
            # the readers between the producer and the fetch take the twin
            for op in block.ops:
                if op is producer:
                    continue
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [
                        twin_name if n == name else n for n in names]
            block.append_op(type="cast", inputs={"X": [twin_name]},
                            outputs={"Out": [name]},
                            attrs={"out_dtype": "float32"})
            var.dtype = torch.float32


# the reference's name; here the half type is bfloat16
Float16Transpiler = Bfloat16Transpiler
