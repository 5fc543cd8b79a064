"""``quantize_inference``: the int8 program rewrite (counterpart of
``paddle_tpu/transpiler/quantize_pass.py``, copied, since the JAX package
cannot be imported here).

Every matmul/mul weight becomes an int8 persistable plus a per-output-
channel dequant-scale vector, and the op becomes ``dequant_matmul``
(``ops/quantize.py``, kernel #7 on the card).  Two modes:

* ``weight_only`` — weights int8, activations untouched;
* ``dynamic`` — activations also quantize per row to int8 and the product
  accumulates in int32; a trained QAT activation scale
  (``fake_quantize_range_abs_max`` running state) is consumed as the static
  activation grid instead of re-measured.

A weight fed through a QAT fake-quant op deploys on the grid QAT trained
against (its ``OutScale`` envelope), and the weight-side fake-quant op
disappears from the rewritten program.

The grid is computed on the host in numpy float64 exactly as the JAX
package computes it, so the int8 weights and scales equal the JAX
package's bit for bit.  Scope values are tensors: the pass reads them with
``.detach().cpu().numpy()`` and writes ``<w>@INT8`` / ``<w>@INT8_SCALE``
onto the weight's own device, so an engine's scope keeps its int8 weights
on the card.
"""

import numpy as np
import torch

from ..framework import Operator
from ..registry import infer_op
from ..scope import global_scope

__all__ = ["quantize_inference", "QUANT_SUFFIX", "SCALE_SUFFIX"]

QUANT_SUFFIX = "@INT8"
SCALE_SUFFIX = "@INT8_SCALE"

_FAKE_QUANT_OPS = ("fake_quantize_abs_max", "fake_quantize_range_abs_max")
_MODES = ("weight_only", "dynamic")


def _numpy(value):
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _device(value):
    return value.device if isinstance(value, torch.Tensor) \
        else torch.device("cpu")


def _trained_scale(op, scope):
    """The trained QAT calibration envelope of a fake-quant op, or None
    when no usable state exists (abs_max ops are stateless; a zero running
    scale means the state was never trained)."""
    if op is None or op.type != "fake_quantize_range_abs_max":
        return None
    names = op.inputs.get("InScale") or []
    if not names or not scope.has_var(names[0]):
        return None
    s = np.asarray(_numpy(scope.var(names[0])), dtype=np.float64).ravel()
    if s.size == 0 or float(np.max(s)) <= 0:
        return None
    return s


def _floatish(var):
    return var.dtype is not None and var.dtype.is_floating_point


def quantize_inference(program, scope=None, mode="weight_only",
                       weight_bits=8, reuse_existing=False):
    """Return a NEW program with matmul/mul weights rewritten to int8
    ``dequant_matmul`` execution; ``scope`` gains the ``<w>@INT8`` /
    ``<w>@INT8_SCALE`` persistable values.  The input program is never
    mutated.

    ``reuse_existing=True`` trusts ``@INT8``/``@INT8_SCALE`` values already
    in the scope instead of re-quantizing (the grid does not depend on the
    mode): the shared-scope case, where ``DecoderSpec.quantize`` rewrites
    three programs over one weight set and quantizes each weight once."""
    if mode not in _MODES:
        raise ValueError("quantize_inference mode must be one of %s, "
                         "got %r" % (_MODES, mode))
    scope = scope if scope is not None else global_scope()
    out = program.clone(for_test=True)
    block = out.global_block()
    rng_max = float((1 << (int(weight_bits) - 1)) - 1)

    producers = {}
    for op in block.ops:
        for nm in op.output_arg_names:
            if nm:
                producers[nm] = op

    converted = {}          # weight name -> (int8 name, scale name)
    info = {"mode": mode, "weight_bits": int(weight_bits), "weights": {}}
    new_ops = []
    for op in block.ops:
        if op.type not in ("mul", "matmul"):
            new_ops.append(op)
            continue
        if op.type == "matmul" and (op.attrs.get("transpose_X")
                                    or op.attrs.get("transpose_Y")
                                    or op.attrs.get("alpha", 1.0) != 1.0):
            new_ops.append(op)
            continue
        if op.type == "mul" and op.attrs.get("y_num_col_dims", 1) != 1:
            new_ops.append(op)
            continue
        x_name = op.inputs["X"][0]
        y_name = op.inputs["Y"][0]
        # unwrap a QAT weight fake-quant: its raw input is the weight, its
        # trained envelope the calibration
        wname, w_fq = y_name, None
        p = producers.get(y_name)
        if p is not None and p.type in _FAKE_QUANT_OPS:
            wname, w_fq = p.inputs["X"][0], p
        wvar = block._find_var_recursive(wname)
        if wvar is None or not wvar.persistable or not _floatish(wvar) \
                or not scope.has_var(wname):
            new_ops.append(op)
            continue
        wval = scope.var(wname)
        w = _numpy(wval)
        if w.ndim != 2:
            new_ops.append(op)
            continue

        if wname not in converted:
            n_out = w.shape[1]
            qname = wname + QUANT_SUFFIX
            sname = wname + SCALE_SUFFIX
            if reuse_existing and scope.has_var(qname) \
                    and scope.has_var(sname) \
                    and tuple(scope.var(qname).shape) == tuple(w.shape):
                # shared-scope case: the values are already there
                calibration, q_size = "reused", int(w.size)
            else:
                w64 = np.asarray(w, np.float64)
                fq_scale = _trained_scale(w_fq, scope)
                if fq_scale is not None:
                    # the trained envelope IS the grid QAT optimized
                    # against (a scalar envelope broadcasts)
                    sw = fq_scale if fq_scale.size == n_out else np.full(
                        (n_out,), float(fq_scale.ravel()[0]), np.float64)
                    calibration = "qat_out_scale"
                else:
                    sw = np.abs(w64).max(axis=0)
                    calibration = "abs_max"
                sw = np.maximum(sw, 1e-12) / rng_max  # dequant multiplier
                q = np.clip(np.round(w64 / sw), -rng_max,
                            rng_max).astype(np.int8)
                dev = _device(wval)
                scope.set_var(qname, torch.from_numpy(q).to(dev))
                scope.set_var(sname, torch.from_numpy(
                    sw.astype(np.float32)).to(dev))
                q_size = int(q.size)
            block.create_var(name=qname, shape=tuple(w.shape),
                             dtype="int8", persistable=True)
            block.create_var(name=sname, shape=(int(n_out),),
                             dtype="float32", persistable=True)
            converted[wname] = (qname, sname)
            info["weights"][wname] = {
                "int8": qname, "scale": sname,
                "calibration": calibration,
                "bytes_fp": int(wval.numel() * wval.element_size()
                                if isinstance(wval, torch.Tensor)
                                else w.nbytes),
                "bytes_int8": q_size}
        qname, sname = converted[wname]

        # activation side: a trained QAT activation envelope feeds the
        # dynamic mode as a static grid; weight-only leaves activation
        # fake-quants alone (they are the numerics QAT trained)
        raw_x, xscale = x_name, None
        if mode == "dynamic":
            px = producers.get(x_name)
            if px is not None and px.type in _FAKE_QUANT_OPS:
                ts = _trained_scale(px, scope)
                if ts is not None:
                    raw_x = px.inputs["X"][0]
                    xscale = px.inputs["InScale"][0]
        xvar = block._find_var_recursive(raw_x)
        xnc = op.attrs.get("x_num_col_dims", 1) if op.type == "mul" \
            else max(1, len(xvar.shape) - 1)
        inputs = {"X": [raw_x], "QWeight": [qname], "Scale": [sname]}
        if xscale is not None:
            inputs["XScale"] = [xscale]
        nop = Operator(block, type="dequant_matmul", inputs=inputs,
                       outputs={"Out": list(op.outputs["Out"])},
                       attrs={"x_num_col_dims": xnc, "mode": mode,
                              "bit_length": int(weight_bits)})
        infer_op(nop, block)
        new_ops.append(nop)

    if not converted:
        block.ops = new_ops
        out._version += 1
        out._quantize_info = info
        return out

    # consumed fake-quant ops disappear: a weight-side (or bypassed
    # activation-side) fake-quant whose Out no longer feeds anything else
    consumed_by = {}
    for i, op in enumerate(new_ops):
        for nm in op.input_arg_names:
            if nm:
                consumed_by.setdefault(nm, set()).add(i)
    final_ops = []
    for i, op in enumerate(new_ops):
        if op.type in _FAKE_QUANT_OPS:
            users = set()
            for nm in op.outputs.get("Out", []):
                users |= consumed_by.get(nm, set())
            users.discard(i)
            if not users:
                continue
        final_ops.append(op)
    block.ops = final_ops
    out._version += 1
    out._quantize_info = info
    return out
