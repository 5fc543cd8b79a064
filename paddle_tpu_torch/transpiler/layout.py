"""Whole-trunk NHWC layout pass — the data-layout-transform analog.

A copy of ``paddle_tpu/transpiler/layout.py`` (pure Python over the
program; the port keeps its own copy because importing the JAX package
imports JAX).  In the port the NHWC trunk feeds kernels #10/#11 and the
channels-last ``F.conv2d``/pooling of ``ops/conv.py`` and ``ops/pool.py``.

The reference transforms tensor layouts at kernel boundaries when a
kernel wants a different layout than its input carries
(``paddle/fluid/framework/data_layout_transform.cc:1``, and the cuDNN
conv kernels' layout negotiation in
``paddle/fluid/operators/conv_cudnn_op.cu.cc:1``).  On TPU the
motivation is different — XLA's layout assignment already normalizes a
pure conv trunk (measured: NCHW == NHWC end-to-end, PERF.md r4) — but
*custom kernels* (the Pallas fused conv+BN family) tile as [M=B*H*W, C]
row-major, which is exactly flattened NHWC: under an NCHW program every
fused-op boundary materializes an NCHW<->NHWC transpose (measured 2.4x
regression, PERF.md), under an NHWC program none do.

``convert_to_nhwc`` rewrites the global block in place so the conv
trunk runs feature-last:

* ``conv2d``/``depthwise_conv2d`` become ``data_format=NHWC`` ops; ONE
  transpose is inserted where a trunk enters (the fed NCHW image);
  filters stay OIHW in the program (checkpoint/API parity — the conv
  kernel transposes the small weight tensor internally).
* ``batch_norm`` (``data_layout``), ``pool2d`` (``data_format``),
  unary activations/dropout/cast/scale, and trunk-trunk elementwise
  ops propagate the layout without touching bytes.
* Every other consumer of a trunk var gets an inserted NHWC->NCHW
  boundary transpose (the fc head's global-pool input is [B,1,1,C] vs
  [B,C,1,1] — byte-identical, XLA folds the transpose to a bitcast).

Var NAMES are preserved; only shape metadata flips to NHWC — fetching
an interior trunk var therefore yields NHWC data, the documented
contract of opting into the pass (the reference's transformed interior
is equally layout-rewritten).  Run BEFORE ``fuse_conv_bn`` (which
understands both layouts) and BEFORE ``append_backward``/``minimize``
so gradients derive from the rewritten program.
"""

from ..framework import Operator
from ..registry import infer_op

__all__ = ["convert_to_nhwc"]

# ops that pass layout through untouched (same-shape unary families)
_UNARY_PASS = {
    "relu", "relu6", "sigmoid", "tanh", "leaky_relu", "elu", "softplus",
    "softsign", "sqrt", "abs", "square", "exp", "swish", "hard_sigmoid",
    "brelu", "soft_relu", "pow", "stanh", "thresholded_relu", "dropout",
    "scale", "cast",
}

_EW_PASS = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
}


def _is_4d(block, name):
    v = block._find_var_recursive(name)
    return v is not None and v.shape is not None and len(v.shape) == 4


def _is_rank1(block, name):
    v = block._find_var_recursive(name)
    return v is not None and v.shape is not None and len(v.shape) == 1


def convert_to_nhwc(program):
    """Rewrite the global block's conv trunk to NHWC in place; returns
    the number of convolutions converted."""
    block = program.global_block()
    ops = block.ops
    new_ops = []
    nhwc = set()          # var names currently carrying NHWC data
    entry_cache = {}      # NCHW var -> its @NHWC transposed alias
    exit_cache = {}       # NHWC var -> its @NCHW transposed alias
    converted = 0

    def emit_transpose(src, dst, perm):
        op = Operator(block, type="transpose", inputs={"X": [src]},
                      outputs={"Out": [dst]}, attrs={"axis": perm})
        infer_op(op, block)
        new_ops.append(op)

    def to_nhwc(name):
        if name not in entry_cache:
            alias = name + "@NHWC"
            emit_transpose(name, alias, [0, 2, 3, 1])
            nhwc.add(alias)
            entry_cache[name] = alias
        return entry_cache[name]

    def to_nchw(name):
        if name not in exit_cache:
            alias = name + "@NCHW"
            emit_transpose(name, alias, [0, 3, 1, 2])
            exit_cache[name] = alias
        return exit_cache[name]

    for op in ops:
        t = op.type
        if t in ("conv2d", "depthwise_conv2d") \
                and op.attrs.get("data_format", "NCHW") == "NCHW" \
                and _is_4d(block, op.inputs["Input"][0]):
            x = op.inputs["Input"][0]
            if x not in nhwc:
                op.inputs["Input"] = [to_nhwc(x)]
            op.attrs["data_format"] = "NHWC"
            nhwc.add(op.outputs["Output"][0])
            infer_op(op, block)
            new_ops.append(op)
            converted += 1
            continue
        if t == "batch_norm" and op.inputs["X"][0] in nhwc:
            op.attrs["data_layout"] = "NHWC"
            nhwc.add(op.outputs["Y"][0])
            infer_op(op, block)
            new_ops.append(op)
            continue
        if t == "pool2d" and op.inputs["X"][0] in nhwc:
            op.attrs["data_format"] = "NHWC"
            nhwc.add(op.outputs["Out"][0])
            infer_op(op, block)
            new_ops.append(op)
            continue
        if t in _UNARY_PASS and op.inputs.get("X") \
                and op.inputs["X"][0] in nhwc:
            for names in op.outputs.values():
                nhwc.update(n for n in names if n)
            infer_op(op, block)
            new_ops.append(op)
            continue
        if t in _EW_PASS and op.inputs.get("X") and op.inputs.get("Y"):
            x, y = op.inputs["X"][0], op.inputs["Y"][0]
            if x in nhwc or y in nhwc:
                if x in nhwc and y in nhwc:
                    pass
                elif x in nhwc and _is_4d(block, y):
                    op.inputs["Y"] = [to_nhwc(y)]
                elif y in nhwc and _is_4d(block, x):
                    op.inputs["X"] = [to_nhwc(x)]
                elif x in nhwc and op.attrs.get("axis", -1) == 1 \
                        and _is_rank1(block, y):
                    # per-channel RANK-1 vector broadcast: C moved to
                    # the last axis, broadcasting's default (-1)
                    # alignment; higher-rank Y (e.g. [C,1,1]) would
                    # mis-align against (H,W,C) and falls through to
                    # the boundary path below
                    op.attrs["axis"] = -1
                else:
                    # un-convertible operand mix: leave the trunk here
                    op.inputs["X"] = [to_nchw(x) if x in nhwc else x]
                    op.inputs["Y"] = [to_nchw(y) if y in nhwc else y]
                    infer_op(op, block)
                    new_ops.append(op)
                    continue
                nhwc.add(op.outputs["Out"][0])
                infer_op(op, block)
                new_ops.append(op)
                continue
        # generic boundary: any other consumer reads NCHW
        changed = False
        for slot, names in op.inputs.items():
            if any(n in nhwc for n in names):
                op.inputs[slot] = [to_nchw(n) if n in nhwc else n
                                   for n in names]
                changed = True
        if changed:
            infer_op(op, block)
        new_ops.append(op)

    block.ops = new_ops
    program._version += 1
    return converted
