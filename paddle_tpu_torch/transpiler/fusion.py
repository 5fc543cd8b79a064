"""Program-level fusion passes — the ir::Graph pass analog.

A copy of ``paddle_tpu/transpiler/fusion.py`` (the pass is pure Python over
the program; the port keeps its own copy because importing the JAX package
imports JAX).  Where the text below counts on XLA to eliminate the dead
``bn_apply``/``relu`` ops the pass re-emits, the port's ``Executor`` skips
ops whose outputs nothing reads (``executor.py``).

The reference rewrites graphs with C++ IR passes
(``paddle/fluid/framework/ir/graph.h``, and later releases ship a
``conv_bn_fuse_pass``); here a pass is a function over a ``Program``
rewriting its op list before ``append_backward``/``minimize`` runs, so
gradients are derived from the rewritten ops.

``fuse_conv_bn`` decomposes train-mode ``batch_norm`` ops and absorbs
eligible 1x1 convolutions into ``bn_act_conv2d`` fused ops
(``ops/fused_conv_bn.py``):

    conv2d(1x1) -> batch_norm -> relu -> conv2d(1x1) -> batch_norm ...

becomes

    bn_act_conv2d(+stats) -> stats_finalize -> bn_update_stats
                          -> bn_act_conv2d(normalize+relu prologue, +stats)

Each activation is then touched the minimum number of HBM passes: conv
outputs' statistics accumulate in the producing kernel's epilogue
(``stats_finalize`` is [C] arithmetic), and the normalize+relu runs in
the consuming kernel's prologue instead of materializing a normalized
copy.  BN semantics (running-stat momentum updates, SavedMean/
SavedVariance outputs, the three-term backward) are preserved — the
backward emerges from the decomposed graph's chain rule.

The pass refuses to rewrite when ``FLAGS_bn_two_pass`` is set: the
fused stats are one-pass by construction, and the flag's contract is
exact two-pass variance.
"""

from ..framework import Operator
from ..registry import infer_op, int_list

__all__ = ["fuse_conv_bn"]


def _is_conv1x1_s1(op, block):
    if op.type != "conv2d":
        return False
    if (op.attrs.get("groups", 1) or 1) != 1:
        return False
    strides = int_list(op.attrs.get("strides", 1), 2)
    pads = int_list(op.attrs.get("paddings", 0), 2)
    dils = int_list(op.attrs.get("dilations", 1), 2)
    if strides != [1, 1] or pads != [0, 0] or dils != [1, 1]:
        return False
    w = block._find_var_recursive(op.inputs["Filter"][0])
    x = block._find_var_recursive(op.inputs["Input"][0])
    if w is None or x is None or len(w.shape) != 4 or len(x.shape) != 4:
        return False
    return w.shape[2] == 1 and w.shape[3] == 1


def _is_train_bn(op, block):
    if op.type != "batch_norm":
        return False
    if op.attrs.get("is_test", False) or op.attrs.get("use_global_stats",
                                                      False):
        return False
    # NCHW programs and convert_to_nhwc-rewritten trunks both fuse; the
    # decomposed/fused ops carry the layout through their attrs
    if op.attrs.get("data_layout", "NCHW") not in ("NCHW", "NHWC"):
        return False
    x = block._find_var_recursive(op.inputs["X"][0])
    return x is not None and x.shape is not None and len(x.shape) == 4


def fuse_conv_bn(program):
    """Rewrite the global block in place; returns the number of
    batch_norm ops decomposed.  Must run BEFORE append_backward /
    optimizer.minimize (grad ops are derived from the rewritten
    program)."""
    from ..flags import flag

    if flag("bn_two_pass"):
        return 0

    block = program.global_block()
    ops = block.ops

    consumers = {}
    producer = {}
    for i, op in enumerate(ops):
        for name in op.input_arg_names:
            if name:
                consumers.setdefault(name, []).append(i)
        for name in op.output_arg_names:
            if name:
                producer[name] = i

    bn_idx = [i for i, op in enumerate(ops) if _is_train_bn(op, block)]
    if not bn_idx:
        return 0

    # --- plan -------------------------------------------------------------
    # consumer fusion: bn.Y [-> relu R] -> conv2d(1x1 s1); every link must
    # be the single consumer of its var
    absorbed_relu = set()    # relu op indices folded into a fused op
    absorbed_conv = {}       # conv op index -> (bn index, act)
    for i in bn_idx:
        bn = ops[i]
        y = bn.outputs["Y"][0]
        cons = consumers.get(y, [])
        act = ""
        tail = y
        j = cons[0] if len(cons) == 1 else -1
        if j >= 0 and ops[j].type == "relu":
            act = "relu"
            tail = ops[j].outputs["Out"][0]
            tcons = consumers.get(tail, [])
            k = tcons[0] if len(tcons) == 1 else -1
        else:
            k = j
        if k >= 0 and _is_conv1x1_s1(ops[k], block) \
                and ops[k].inputs["Input"][0] == tail \
                and ops[k].attrs.get("data_format", "NCHW") == \
                bn.attrs.get("data_layout", "NCHW"):
            if act == "relu":
                absorbed_relu.add(j)
            absorbed_conv[k] = (i, act)

    # producer-stats fusion: a 1x1 conv whose output is consumed ONLY by a
    # train-mode bn's X emits sum/sumsq from its kernel epilogue
    stats_conv = set()       # conv op indices that must emit stats
    bn_stats_src = {}        # bn index -> conv op index
    stats_consumer_bn = {}   # conv op index -> bn index consuming stats
    for i in bn_idx:
        x = ops[i].inputs["X"][0]
        p = producer.get(x)
        if p is not None and _is_conv1x1_s1(ops[p], block) \
                and consumers.get(x, []) == [i] \
                and ops[p].attrs.get("data_format", "NCHW") == \
                ops[i].attrs.get("data_layout", "NCHW"):
            stats_conv.add(p)
            bn_stats_src[i] = p
            stats_consumer_bn[p] = i

    # --- rebuild ----------------------------------------------------------
    def stat_names(conv_op):
        z = conv_op.outputs["Output"][0]
        return z + "@BNSUM", z + "@BNSUMSQ"

    def make_op(type, inputs, outputs, attrs):
        op = Operator(block, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        infer_op(op, block)
        return op

    def emit_fused_conv(conv_i, new_ops):
        conv = ops[conv_i]
        with_stats = conv_i in stats_conv
        fmt = conv.attrs.get("data_format", "NCHW")
        # stat outputs always get real (dead when unused) names — an
        # empty-string output would register a phantom "" block var
        sum_n, sumsq_n = stat_names(conv)
        if conv_i in absorbed_conv:
            b_i, act = absorbed_conv[conv_i]
            bn = ops[b_i]
            inputs = {"X": list(bn.inputs["X"]),
                      "Filter": list(conv.inputs["Filter"]),
                      "BatchMean": list(bn.outputs["SavedMean"]),
                      "BatchVar": list(bn.outputs["SavedVariance"]),
                      "Scale": list(bn.inputs["Scale"]),
                      "Bias": list(bn.inputs["Bias"])}
            attrs = {"apply_bn": True, "act": act,
                     "with_stats": with_stats, "data_format": fmt,
                     "epsilon": bn.attrs.get("epsilon", 1e-5)}
        else:
            inputs = {"X": list(conv.inputs["Input"]),
                      "Filter": list(conv.inputs["Filter"])}
            attrs = {"apply_bn": False, "act": "",
                     "with_stats": with_stats, "data_format": fmt,
                     "epsilon": 1e-5}
        if with_stats:
            # the consumer bn's running mean shifts the fused sum/sumsq
            # accumulation (same cancellation guard as ops/norm.py's
            # shifted one-pass variance)
            consumer_bn = ops[stats_consumer_bn[conv_i]]
            inputs["StatsShift"] = list(consumer_bn.inputs["Mean"])
        new_ops.append(make_op(
            "bn_act_conv2d", inputs,
            {"Out": list(conv.outputs["Output"]),
             "SumOut": [sum_n], "SumSqOut": [sumsq_n]},
            attrs))

    new_ops = []
    fused = 0
    for i, op in enumerate(ops):
        # absorbed relu ops are RE-EMITTED (not skipped): their output
        # var may be fetched or read elsewhere; they read the bn_apply'd
        # Y and are dead code XLA eliminates when nothing consumes them
        if i in absorbed_conv or i in stats_conv:
            emit_fused_conv(i, new_ops)
            continue
        if i in bn_idx:
            bn = op
            layout = bn.attrs.get("data_layout", "NCHW")
            x_n = bn.inputs["X"][0]
            saved_mean = bn.outputs["SavedMean"][0]
            saved_var = bn.outputs["SavedVariance"][0]
            src = bn_stats_src.get(i)
            if src is not None:
                sum_n, sumsq_n = stat_names(ops[src])
                new_ops.append(make_op(
                    "stats_finalize",
                    {"Sum": [sum_n], "SumSq": [sumsq_n],
                     "CountFrom": [x_n],
                     "Shift": list(bn.inputs["Mean"])},
                    {"BatchMean": [saved_mean], "BatchVar": [saved_var]},
                    {"data_layout": layout}))
            else:
                new_ops.append(make_op(
                    "batch_stats",
                    {"X": [x_n], "Shift": list(bn.inputs["Mean"])},
                    {"BatchMean": [saved_mean], "BatchVar": [saved_var]},
                    {"data_layout": layout}))
            new_ops.append(make_op(
                "bn_update_stats",
                {"Mean": list(bn.inputs["Mean"]),
                 "Variance": list(bn.inputs["Variance"]),
                 "BatchMean": [saved_mean], "BatchVar": [saved_var]},
                {"MeanOut": list(bn.outputs["MeanOut"]),
                 "VarianceOut": list(bn.outputs["VarianceOut"])},
                {"momentum": bn.attrs.get("momentum", 0.9)}))
            # Y is always re-emitted via bn_apply: un-absorbed consumers
            # (residual adds, 3x3 convs, user fetches) read it, and when
            # every consumer was absorbed the op is dead code XLA
            # eliminates inside the one-jaxpr step
            y = bn.outputs["Y"][0]
            new_ops.append(make_op(
                "bn_apply",
                {"X": [x_n], "BatchMean": [saved_mean],
                 "BatchVar": [saved_var],
                 "Scale": list(bn.inputs["Scale"]),
                 "Bias": list(bn.inputs["Bias"])},
                {"Y": [y]},
                {"epsilon": bn.attrs.get("epsilon", 1e-5), "act": "",
                 "data_layout": layout}))
            fused += 1
            continue
        new_ops.append(op)
    block.ops = new_ops
    program._version += 1
    return fused
