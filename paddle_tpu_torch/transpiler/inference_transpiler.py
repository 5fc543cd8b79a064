"""``InferenceTranspiler`` (counterpart of
``paddle_tpu/transpiler/inference_transpiler.py``): an inference copy of a
program with each frozen batch norm folded into the convolution before it.

The fold is the JAX package's arithmetic, in float64 on the host and
rounded back to the weight's dtype, so the folded values are the same
bits::

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)

The batch norm then disappears and its ``Y`` becomes ``conv_out + b'``,
one ``elementwise_add`` (axis 1).  The folded weights are new persistable
variables (``<w>@BNFOLD@<y>``, ``<w>@BNFOLD_BIAS@<y>``) written to the
scope on the device of the weight they come from."""

import numpy as np
import torch

from ..framework import Operator, Program
from ..registry import infer_op
from ..scope import global_scope

__all__ = ["InferenceTranspiler"]


def _host64(scope, name):
    return scope.var(name).detach().cpu().double().numpy()


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Return an inference COPY of ``program``: train-mode ops switch to
        ``is_test`` (``clone(for_test=True)``), then frozen batch-norm
        statistics fold into the preceding conv's weights (new values
        written to ``scope``).  The input program is not changed."""
        if not isinstance(program, Program):
            raise TypeError("program should be a Program")
        scope = scope if scope is not None else global_scope()
        cloned = program.clone(for_test=True)
        self._fuse_batch_norm(cloned, scope)
        return cloned

    def _fuse_batch_norm(self, program, scope):
        """Fold every ``is_test`` / ``use_global_stats`` batch norm whose
        input is a ``conv2d`` output read by nothing else; returns how many
        were folded."""
        block = program.global_block()
        ops = block.ops
        consumers, producer = {}, {}
        for i, op in enumerate(ops):
            for n in op.input_arg_names:
                if n:
                    consumers.setdefault(n, []).append(i)
            for n in op.output_arg_names:
                if n:
                    producer[n] = i
        rewires = {}     # bn op index -> (conv output, folded bias, bn's Y)
        for i, op in enumerate(ops):
            if op.type != "batch_norm" or not (
                    op.attrs.get("is_test")
                    or op.attrs.get("use_global_stats")):
                continue
            x = op.inputs["X"][0]
            p = producer.get(x)
            if p is None or ops[p].type != "conv2d" \
                    or consumers.get(x, []) != [i]:
                continue
            conv = ops[p]
            w_name = conv.inputs["Filter"][0]
            if not scope.has_var(w_name):
                continue     # parameters not materialized: nothing to fold
            gamma, beta, mean, var = (
                _host64(scope, op.inputs[s][0])
                for s in ("Scale", "Bias", "Mean", "Variance"))
            w_t = scope.var(w_name)
            w = w_t.detach().cpu().numpy()
            scale = gamma / np.sqrt(var + op.attrs.get("epsilon", 1e-5))
            w_f = (w.astype(np.float64)
                   * scale[:, None, None, None]).astype(w.dtype)
            b_f = (beta - mean * scale).astype(w.dtype)
            # one name a batch norm: a filter shared by two convs followed
            # by different batch norms folds to two values
            y_name = op.outputs["Y"][0]
            folded_w = "%s@BNFOLD@%s" % (w_name, y_name)
            folded_b = "%s@BNFOLD_BIAS@%s" % (w_name, y_name)
            wv = block._find_var_recursive(w_name)
            block.create_var(name=folded_w, shape=wv.shape, dtype=wv.dtype,
                             persistable=True)
            block.create_var(name=folded_b, shape=(w.shape[0],),
                             dtype=wv.dtype, persistable=True)
            scope.set_var(folded_w, torch.from_numpy(w_f).to(w_t.device))
            scope.set_var(folded_b, torch.from_numpy(b_f).to(w_t.device))
            conv.inputs["Filter"] = [folded_w]
            rewires[i] = (x, folded_b, y_name)
        if not rewires:
            return 0
        new_ops = []
        for i, op in enumerate(ops):
            if i in rewires:
                conv_out, bias_name, y = rewires[i]
                op = Operator(block, type="elementwise_add",
                              inputs={"X": [conv_out], "Y": [bias_name]},
                              outputs={"Out": [y]}, attrs={"axis": 1})
                infer_op(op, block)
            new_ops.append(op)
        block.ops = new_ops
        program._version += 1
        return len(rewires)
