"""The plain op library held against the JAX package on the CPU.

Each of the 58 op types the port gained with it (the comparisons, the
logical ops and ``elementwise_mod`` / ``_floordiv``; ``reduce_max`` /
``_min`` / ``_prod``, ``arg_max`` / ``arg_min`` and ``cumsum``; ``minus``,
``l1_norm``, ``squared_l2_distance``, ``isfinite``, ``has_inf``,
``has_nan``; the 19 manipulation ops; ``shape``, ``fill_zeros_like``,
the two ``*_random_batch_size_like`` and ``print``; ``sampling_id`` and
``random_crop``; the eight losses) runs as a one-op program built in both
packages: the programs serialize alike, float outputs agree within rtol
1e-5 / atol 1e-5, bool and integer outputs bit for bit (an int64 output
against the JAX package's int32 by value: the port keeps int64 ids), and
the gradients of ``mean(Out * w)`` with respect to every floating input
the JAX op differentiates within relative L2 1e-5.  The edge cases the
ops' semantics hinge on are cases of their own: ties for the arg and max
reductions and the comparisons, one and two zeros in a ``reduce_prod``
row, repeated, negative and out-of-range ids for ``gather``, ``scatter``,
``multiplex`` and ``one_hot``, ``exclusive`` / ``reverse`` cumsum, NaN
and ties in ``argsort``, integer division by zero.  The random ops are
held by their distributions, a fixed-seed run against a second one and
their programs; ``print`` by what it writes.  A sweep checks that every
forward op type of the port's registry has a parity case."""

import ast
import os
import re

import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_serving import fresh_torch_programs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_op(pkg, op_type, inputs, attrs, outputs, diff, seed=0):
    """(program dict, outputs, gradients of ``diff``'s inputs) of one op.

    ``inputs`` maps a slot to an array or a list of arrays (each fed as a
    data var of its own), ``outputs`` a slot to its number of vars; the
    loss ``mean(first output * w)`` is differentiated when ``diff`` names
    slots.  Outputs and gradients come flattened in slot order."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    feed = {}
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        ins = {}
        for slot, arr in inputs.items():
            arrs = arr if isinstance(arr, list) else [arr]
            ins[slot] = []
            for i, a in enumerate(arrs):
                name = slot.lower() + ("%d" % i if isinstance(arr, list)
                                       else "")
                v = pkg.layers.data(name, shape=list(a.shape),
                                    append_batch_size=False,
                                    dtype=str(a.dtype))
                v.stop_gradient = slot not in diff
                ins[slot].append(v)
                feed[name] = a
        outs = {s: [block.create_var(name=pkg.unique_name.generate(
            s.lower())) for _ in range(n)] for s, n in outputs.items()}
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs=dict(attrs))
        head = next(iter(outs.values()))[0]
        grads = []
        if diff:
            w = pkg.layers.data("loss_w", shape=list(head.shape),
                                append_batch_size=False)
            feed["loss_w"] = np.random.RandomState(1).rand(
                *[int(d) for d in head.shape]).astype("float32")
            pkg.backward.append_backward(
                pkg.layers.mean(pkg.layers.elementwise_mul(head, w)))
            grads = [v.name + "@GRAD" for s in diff for v in ins[s]]
    fetch = [v for s in outputs for v in outs[s]] + grads
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    got = [np.asarray(v) for v in exe.run(main, feed=feed,
                                          fetch_list=fetch, scope=scope)]
    n = len(got) - len(grads)
    return main.to_dict(), got[:n], got[n:]


def _same_values(got, want):
    """Bit for bit; the port's int64 against the JAX package's int32 by
    value."""
    if {got.dtype, want.dtype} == {np.dtype("int64"), np.dtype("int32")}:
        return np.array_equal(got, want.astype("int64"))
    return got.dtype == want.dtype and np.array_equal(got, want,
                                                      equal_nan=True)


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _case(op_type, inputs, attrs=None, outputs=None, diff=(), exact=False,
          id=None):
    return pytest.param(op_type, inputs, attrs or {}, outputs or {"Out": 1},
                        diff, exact, id=id or op_type)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


def _ties(rng, *shape, lo=-2, hi=3):
    """Small integers as float32: many ties."""
    return rng.randint(lo, hi, shape).astype("float32")


def _cases():
    rng = np.random.RandomState(0)
    cmp_x, cmp_y = _ties(rng, 4, 5), _ties(rng, 4, 5)
    bx, by = rng.rand(4, 5) > 0.5, rng.rand(4, 5) > 0.5
    prod = _randn(rng, 4, 5)
    prod[1, 2] = 0.0                         # one zero in row 1
    prod[2, [0, 3]] = 0.0                    # two zeros in row 2
    nonfinite = [_randn(rng, 3, 4), _randn(rng, 2, 3)]
    nonfinite[1][1, 2] = np.inf
    with_nan = [_randn(rng, 3, 4), _randn(rng, 2, 3)]
    with_nan[0][2, 1] = np.nan
    sort_x = _ties(rng, 3, 7)
    sort_x[0, 2] = sort_x[1, 5] = np.nan
    sort_x[2, 1] = -0.0
    ids = np.asarray([0, -1, 5, 6, -7, 2, 2, -6], "int64")   # 6 rows
    lens = np.asarray([5, 3, 1], "int32")
    score = _randn(rng, 3, 5, 1)
    score[0, 1, 0] = score[0, 3, 0]          # a tie in the model's ranking
    cases = [
        _case("elementwise_mod", {"X": _randn(rng, 4, 5, scale=5),
                                  "Y": _randn(rng, 4, 5) + 0.1},
              diff=("X", "Y")),
        _case("elementwise_mod", {"X": _randn(rng, 4, 5, scale=5),
                                  "Y": _randn(rng, 5) + 0.1},
              {"axis": 1}, diff=("X", "Y"), id="elementwise_mod_axis"),
        _case("elementwise_mod", {
            "X": rng.randint(-9, 10, (4, 5)).astype("int32"),
            "Y": rng.randint(-3, 4, (4, 5)).astype("int32")}, exact=True,
            id="elementwise_mod_int_zero_divisor"),
        _case("elementwise_floordiv", {"X": _randn(rng, 4, 5, scale=5),
                                       "Y": _randn(rng, 4, 5) + 0.1},
              diff=("X", "Y")),
        _case("elementwise_floordiv", {
            "X": np.asarray([[7.5, -7.5, 7.5, -7.5, 5.0, 0.0]], "float32"),
            "Y": np.asarray([[2.0, 2.0, -2.0, -2.0, 0.0, 0.0]], "float32")},
            exact=True, id="elementwise_floordiv_float_zero_divisor"),
        _case("elementwise_floordiv", {
            "X": rng.randint(-9, 10, (4, 5)).astype("int64"),
            "Y": rng.randint(-3, 4, (4, 5)).astype("int64")}, exact=True,
            id="elementwise_floordiv_int_zero_divisor"),
    ]
    for t in ("less_than", "less_equal", "greater_than", "greater_equal",
              "equal", "not_equal"):
        cases.append(_case(t, {"X": cmp_x, "Y": cmp_y}, exact=True))
    cases += [
        _case("less_than", {"X": cmp_x, "Y": cmp_y[:1]}, exact=True,
              id="less_than_broadcast"),
        _case("logical_and", {"X": bx, "Y": by}, exact=True),
        _case("logical_or", {"X": bx, "Y": by}, exact=True),
        _case("logical_xor", {"X": bx, "Y": by}, exact=True),
        _case("logical_not", {"X": bx}, exact=True),
        _case("reduce_max", {"X": _ties(rng, 4, 5, 3)},
              {"dim": [1], "keep_dim": False}, diff=("X",),
              id="reduce_max_ties"),
        _case("reduce_max", {"X": _randn(rng, 3, 4, 5)},
              {"dim": [0, 2], "keep_dim": True}, diff=("X",),
              id="reduce_max_two_dims"),
        _case("reduce_min", {"X": _ties(rng, 4, 5, 3)},
              {"dim": [0], "reduce_all": True}, diff=("X",),
              id="reduce_min_all_ties"),
        _case("reduce_min", {"X": _randn(rng, 3, 4, 5)},
              {"dim": [-1], "keep_dim": True}, diff=("X",)),
        _case("reduce_prod", {"X": prod}, {"dim": [1]}, diff=("X",),
              id="reduce_prod_zeros"),
        _case("reduce_prod", {"X": _randn(rng, 3, 4, 2) + 1.5},
              {"dim": [0, 2], "keep_dim": True}, diff=("X",),
              id="reduce_prod_two_dims"),
        _case("reduce_prod", {"X": prod}, {"dim": [0], "reduce_all": True},
              diff=("X",), id="reduce_prod_all"),
        _case("arg_max", {"X": _ties(rng, 5, 6)}, {"axis": 1}, exact=True,
              id="arg_max_ties"),
        _case("arg_min", {"X": _ties(rng, 5, 6)}, {"axis": 0}, exact=True,
              id="arg_min_ties"),
        _case("cumsum", {"X": _randn(rng, 4, 6)}, {"axis": -1},
              diff=("X",)),
        _case("cumsum", {"X": _randn(rng, 4, 6)},
              {"axis": 1, "exclusive": True}, diff=("X",),
              id="cumsum_exclusive"),
        _case("cumsum", {"X": _randn(rng, 4, 6)},
              {"axis": 0, "reverse": True}, diff=("X",),
              id="cumsum_reverse"),
        _case("cumsum", {"X": _randn(rng, 4, 6)},
              {"axis": 1, "exclusive": True, "reverse": True},
              diff=("X",), id="cumsum_exclusive_reverse"),
        _case("cumsum", {"X": rng.randint(-5, 5, (3, 4)).astype("int32")},
              {"axis": 1}, exact=True, id="cumsum_int"),
        _case("minus", {"X": _randn(rng, 3, 4), "Y": _randn(rng, 3, 4)},
              diff=("X", "Y")),
        _case("l1_norm", {"X": _randn(rng, 3, 4)}, diff=("X",)),
        _case("squared_l2_distance",
              {"X": _randn(rng, 4, 3, 2), "Y": _randn(rng, 1, 3, 2)},
              outputs={"Out": 1, "sub_result": 1}, diff=("X", "Y")),
        _case("isfinite", {"X": nonfinite}, exact=True),
        _case("isfinite", {"X": with_nan[:1]}, exact=True,
              id="isfinite_nan"),
        _case("has_inf", {"X": nonfinite}, exact=True),
        _case("has_inf", {"X": with_nan}, exact=True, id="has_inf_none"),
        _case("has_nan", {"X": with_nan}, exact=True),
        _case("flatten", {"X": _randn(rng, 2, 3, 4, 2)}, {"axis": 2},
              diff=("X",)),
        _case("flatten", {"X": _randn(rng, 2, 3, 4)}, {"axis": 0},
              diff=("X",), id="flatten_axis0"),
        _case("split", {"X": _randn(rng, 3, 6, 2)},
              {"axis": 1, "sections": [1, 2, 3], "num": 3},
              outputs={"Out": 3}, diff=("X",)),
        _case("split", {"X": _randn(rng, 4, 6)},
              {"axis": -1, "sections": [], "num": 2}, outputs={"Out": 2},
              diff=("X",), id="split_num"),
        _case("stack", {"X": [_randn(rng, 3, 4) for _ in range(3)]},
              {"axis": 1}, outputs={"Y": 1}, diff=("X",)),
        _case("unstack", {"X": _randn(rng, 3, 4, 2)}, {"axis": 1, "num": 4},
              outputs={"Y": 4}, diff=("X",)),
        _case("expand", {"X": _randn(rng, 2, 1, 3)},
              {"expand_times": [2, 4, 1]}, diff=("X",)),
        _case("reverse", {"X": _randn(rng, 3, 4, 2)}, {"axis": [0, 2]},
              diff=("X",)),
        _case("pad", {"X": _randn(rng, 2, 3)},
              {"paddings": [1, 0, 2, 3], "pad_value": 1.5}, diff=("X",)),
        _case("gather", {"X": _randn(rng, 6, 4), "Index": ids},
              diff=("X",), id="gather_negative_out_of_range_repeated"),
        _case("gather", {"X": rng.randint(-9, 9, (6, 3)).astype("int32"),
                         "Index": ids}, exact=True, id="gather_int"),
        _case("scatter", {"X": _randn(rng, 6, 3), "Ids": ids,
                          "Updates": _randn(rng, 8, 3)},
              {"overwrite": True}, diff=("X", "Updates"),
              id="scatter_overwrite_repeated_out_of_range"),
        _case("scatter", {"X": _randn(rng, 6, 3), "Ids": ids,
                          "Updates": _randn(rng, 8, 3)},
              {"overwrite": False}, diff=("X", "Updates"),
              id="scatter_add_repeated_out_of_range"),
        _case("one_hot", {"X": np.asarray([[0], [3], [-1], [5], [2]],
                                          "int64")},
              {"depth": 4}, exact=True, id="one_hot_out_of_range"),
        _case("label_smooth", {"X": rng.rand(4, 5).astype("float32")},
              {"epsilon": 0.1}, diff=("X",)),
        _case("label_smooth", {"X": rng.rand(4, 5).astype("float32"),
                               "PriorDist": rng.rand(1, 5)
                               .astype("float32")},
              {"epsilon": 0.2}, diff=("X", "PriorDist"),
              id="label_smooth_prior"),
        _case("multiplex", {"X": [_randn(rng, 5, 3) for _ in range(3)],
                            "Ids": np.asarray([[2], [0], [-1], [3], [1]],
                                              "int32")},
              diff=("X",), id="multiplex_negative_out_of_range"),
        _case("multiplex", {"X": [_randn(rng, 4, 2, 3) for _ in range(2)],
                            "Ids": np.asarray([[1], [0], [5], [-3]],
                                              "int32")},
              diff=("X",), id="multiplex_rank3_clamped"),
        _case("argsort", {"X": sort_x}, {"axis": -1},
              outputs={"Out": 1, "Indices": 1}, exact=True,
              id="argsort_ties_nan"),
        _case("argsort", {"X": _ties(rng, 5, 3)}, {"axis": 0},
              outputs={"Out": 1, "Indices": 1}, exact=True,
              id="argsort_axis0"),
        _case("crop", {"X": _randn(rng, 4, 5, 6)},
              {"shape": [2, 3, 4], "offsets": [1, 2, 1]}, diff=("X",)),
        _case("crop", {"X": _randn(rng, 4, 5, 6)},
              {"shape": [2, -1, 4], "offsets": [3, 2, -5]},
              id="crop_clamped_rest"),
        _case("crop", {"X": _randn(rng, 4, 5, 6),
                       "Offsets": np.asarray([1, 4, -2], "int32")},
              {"shape": [2, 3, 4]}, diff=("X",), id="crop_runtime_offsets"),
        _case("pad2d", {"X": _randn(rng, 2, 3, 4, 5)},
              {"paddings": [1, 2, 0, 3], "mode": "constant",
               "pad_value": -1.0}, diff=("X",)),
        _case("pad2d", {"X": _randn(rng, 2, 3, 4, 5)},
              {"paddings": [2, 1, 3, 1], "mode": "reflect"}, diff=("X",),
              id="pad2d_reflect"),
        _case("pad2d", {"X": _randn(rng, 2, 4, 5, 3)},
              {"paddings": [1, 2, 2, 0], "mode": "edge",
               "data_format": "NHWC"}, diff=("X",), id="pad2d_edge_nhwc"),
        _case("pad_constant_like", {"X": _randn(rng, 4, 5),
                                    "Y": _randn(rng, 2, 3)},
              {"pad_value": 0.5}, diff=("Y",)),
        _case("is_empty", {"X": _randn(rng, 2, 3)}, exact=True),
        _case("fill", {}, {"shape": [2, 3], "dtype": "float32",
                           "value": [1.5, -2, 3, 0.25, 5, 6]}, exact=True),
        _case("fill", {}, {"shape": [3], "dtype": "int64",
                           "value": [4, -5, 6]}, exact=True,
              id="fill_int64"),
        _case("scale_sub_region",
              {"X": _randn(rng, 2, 3, 4, 5),
               "Indices": np.asarray([[1, 2, 2, 3, 1, 5],
                                      [3, 3, 1, 4, 2, 2]], "int32")},
              {"value": 2.5}, diff=("X",)),
        _case("shape", {"Input": _randn(rng, 2, 3, 4)}, exact=True),
        _case("fill_zeros_like", {"X": _randn(rng, 3, 4)}, exact=True),
        _case("sigmoid_cross_entropy_with_logits",
              {"X": _randn(rng, 4, 5, scale=3),
               "Label": rng.rand(4, 5).astype("float32")}, diff=("X",)),
        _case("sigmoid_cross_entropy_with_logits",
              {"X": np.asarray([[0.0, 1.0, -2.0], [3.0, 0.0, -0.5]],
                               "float32"),
               "Label": np.asarray([[1.0, -1.0, 0.0], [-1.0, 0.0, 1.0]],
                                   "float32")},
              {"ignore_index": -1}, diff=("X",),
              id="sigmoid_cross_entropy_with_logits_ignore"),
        _case("huber_loss", {"X": _randn(rng, 6, 1), "Y": _randn(rng, 6, 1)},
              {"delta": 0.7}, outputs={"Out": 1, "Residual": 1},
              diff=("X",)),
        _case("smooth_l1_loss", {"X": _randn(rng, 4, 3), "Y": _randn(rng, 4, 3),
                                 "InsideWeight": rng.rand(4, 3)
                                 .astype("float32"),
                                 "OutsideWeight": rng.rand(4, 3)
                                 .astype("float32")},
              {"sigma": 1.5}, outputs={"Out": 1, "Diff": 1}, diff=("X",)),
        _case("smooth_l1_loss", {"X": _randn(rng, 4, 3),
                                 "Y": _randn(rng, 4, 3)},
              outputs={"Out": 1, "Diff": 1}, diff=("X",),
              id="smooth_l1_loss_unweighted"),
        _case("hinge_loss", {"Logits": _randn(rng, 6, 1),
                             "Labels": rng.randint(0, 2, (6, 1))
                             .astype("float32")},
              outputs={"Loss": 1}, diff=("Logits",)),
        _case("log_loss", {"Predicted": rng.rand(6, 1).astype("float32"),
                           "Labels": rng.randint(0, 2, (6, 1))
                           .astype("float32")},
              {"epsilon": 1e-4}, outputs={"Loss": 1}, diff=("Predicted",)),
        _case("rank_loss", {"Label": rng.randint(0, 2, (5, 1))
                            .astype("float32"),
                            "Left": _randn(rng, 5, 1),
                            "Right": _randn(rng, 5, 1)},
              diff=("Left", "Right")),
        _case("modified_huber_loss",
              {"X": np.asarray([[-2.0], [-0.5], [0.3], [1.5], [0.9],
                                [-1.2]], "float32"),
               "Y": np.asarray([[1], [0], [1], [1], [0], [0]], "float32")},
              outputs={"Out": 1, "IntermediateVal": 1}, diff=("X",)),
        _case("lambda_cost", {"Score": score,
                              "Rel": rng.randint(0, 4, (3, 5, 1))
                              .astype("float32"),
                              "Length": lens},
              {"ndcg_num": 3}, diff=("Score",), id="lambda_cost_masked"),
        _case("lambda_cost", {"Score": _randn(rng, 2, 4, 1),
                              "Rel": rng.randint(0, 3, (2, 4, 1))
                              .astype("float32")},
              diff=("Score",), id="lambda_cost_full"),
    ]
    return cases


CASES = _cases()


def _older_cases():
    """One-op cases of op types from earlier slices that the port's other
    tests reach only inside models or layers of other names."""
    rng = np.random.RandomState(1)
    lens = np.asarray([4, 1, 3], "int64")
    return [
        _case("elementwise_div", {"X": _randn(rng, 3, 4),
                                  "Y": _randn(rng, 4) + 3.0},
              {"axis": 1}, diff=("X", "Y")),
        _case("elementwise_pow", {"X": rng.rand(3, 4).astype("float32")
                                  + 0.5, "Y": _randn(rng, 3, 4)},
              diff=("X", "Y")),
        _case("cos_sim", {"X": _randn(rng, 4, 5), "Y": _randn(rng, 1, 5)},
              outputs={"Out": 1, "XNorm": 1, "YNorm": 1}, diff=("X", "Y")),
        _case("margin_rank_loss", {"Label": np.asarray(
            [[1], [-1], [1], [-1]], "float32"), "X1": _randn(rng, 4, 1),
            "X2": _randn(rng, 4, 1)}, {"margin": 0.3},
            outputs={"Out": 1, "Activated": 1}, diff=("X1", "X2")),
        _case("squeeze", {"X": _randn(rng, 3, 1, 4, 1)}, {"axes": [1, -1]},
              diff=("X",)),
        _case("unsqueeze", {"X": _randn(rng, 3, 4)}, {"axes": [0, 2]},
              diff=("X",)),
        _case("top_k", {"X": _ties(rng, 4, 6)}, {"k": 3},
              outputs={"Out": 1, "Indices": 1}, exact=True),
        _case("depthwise_conv2d", {"Input": _randn(rng, 2, 3, 6, 5),
                                   "Filter": _randn(rng, 3, 1, 3, 3)},
              {"strides": [1, 2], "paddings": [1, 1], "dilations": [1, 1],
               "groups": 3}, outputs={"Output": 1},
              diff=("Input", "Filter")),
        _case("padding_mask", {"Length": lens,
                               "Ref": _randn(rng, 3, 5, 2)}, exact=True),
        _case("sequence_softmax", {"X": _randn(rng, 3, 5, 1),
                                   "Length": lens}, diff=("X",)),
        _case("add_position_encoding", {"X": _randn(rng, 2, 4, 3),
                                        "Table": _randn(rng, 6, 3)},
              diff=("X",)),
        _case("fill_constant_batch_size_like", {"Input": _randn(rng, 5, 2)},
              {"shape": [-1, 3], "value": 2.5, "dtype": "float32"},
              exact=True),
        _case("lookup_table", {"W": _randn(rng, 7, 3), "Ids": np.asarray(
            [[1], [6], [1], [0]], "int64")}, {"padding_idx": 6},
            diff=("W",)),
    ]


OLDER_CASES = _older_cases()


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff,exact",
                         CASES + OLDER_CASES)
def test_op_follows_jax(op_type, inputs, attrs, outputs, diff, exact):
    want_prog, want, want_g = one_op(fluid, op_type, inputs, attrs,
                                     outputs, diff)
    got_prog, got, got_g = one_op(pt, op_type, inputs, attrs, outputs,
                                  diff)
    assert got_prog == want_prog
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if exact or g.dtype.kind in "biu" or w.dtype.kind in "biu":
            assert _same_values(g, w), (i, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg="output %d" % i)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert np.isfinite(g).all() == np.isfinite(w).all(), i
        assert rel_l2(g, w) <= 1e-5, (i, rel_l2(g, w))


# constants made from the attrs or the input's shape, on the host once:
# on the card the entry's eager run copies them and a capture clones them
# (``ops/creation.py`` ``device_constant``)
HOST_CONSTANTS = {("shape", "torch.from_numpy"), ("fill", "torch.from_numpy")}


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff,exact",
                         CASES + OLDER_CASES)
def test_op_reads_nothing_on_the_host(host_read_guard, op_type, inputs,
                                      attrs, outputs, diff, exact):
    """No op of the library, forward or grad, reads a device value on the
    host (which a CUDA graph cannot capture).  ``torch.prod``'s own
    backward does (a ``nonzero`` to count zeros, on the card), so
    ``reduce_prod`` has its own; under the guard's dispatch mode torch
    takes a zero-safe path there, so only the card's capture shows that
    one (``chip_smoke.py plain_ops``)."""
    one_op(pt, op_type, inputs, attrs, outputs, diff)
    assert set(host_read_guard) <= HOST_CONSTANTS, host_read_guard


def test_scatter_last_update_wins_and_drops():
    """A repeated id keeps the later update, a negative one counts from
    the end, and one out of range after that writes nothing."""
    x = np.zeros((4, 2), "float32")
    ids = np.asarray([1, 1, -1, 4, -5, 2], "int64")
    upd = np.arange(12, dtype="float32").reshape(6, 2) + 100
    _, (out,), _ = one_op(pt, "scatter", {"X": x, "Ids": ids,
                                          "Updates": upd},
                          {"overwrite": True}, {"Out": 1}, ())
    np.testing.assert_array_equal(
        out, [[0, 0], [102, 103], [110, 111], [104, 105]])
    _, (out,), _ = one_op(pt, "scatter", {"X": x, "Ids": ids,
                                          "Updates": upd},
                          {"overwrite": False}, {"Out": 1}, ())
    np.testing.assert_array_equal(
        out, [[0, 0], [202, 204], [110, 111], [104, 105]])


def test_reduce_max_splits_tied_gradient():
    """Two tied maxima share the cotangent evenly, as ``jnp.max``'s."""
    x = np.asarray([[1.0, 3.0, 3.0, 2.0]], "float32")
    _, _, (g,) = one_op(pt, "reduce_max", {"X": x}, {"dim": [1]},
                        {"Out": 1}, ("X",))
    w = np.random.RandomState(1).rand(1).astype("float32")
    np.testing.assert_allclose(g, [[0, w[0] / 2, w[0] / 2, 0]], rtol=1e-6)


def test_integer_division_by_zero_is_xla_s():
    """``x // 0`` and ``x % 0`` on integers give XLA's values on the port
    too (x / 0 = -1 and x rem 0 = x, then the floor's correction), where
    torch's own integer division would raise on the host."""
    x = np.asarray([[7, -7, 0, 5]], "int32")
    y = np.zeros((1, 4), "int32")
    _, (q,), _ = one_op(pt, "elementwise_floordiv", {"X": x, "Y": y}, {},
                        {"Out": 1}, ())
    _, (r,), _ = one_op(pt, "elementwise_mod", {"X": x, "Y": y}, {},
                        {"Out": 1}, ())
    np.testing.assert_array_equal(q, [[-2, -2, -1, -2]])
    np.testing.assert_array_equal(r, [[0, 0, 0, 0]])


# -- the random ops: programs, distributions, repeatability -----------------

RANDOM_CASES = [
    ("uniform_random", {},
     {"shape": [4000, 50], "min": -2.0, "max": 3.0, "dtype": "float32"}),
    ("gaussian_random", {},
     {"shape": [4000, 50], "mean": 1.5, "std": 0.5, "dtype": "float32"}),
    ("uniform_random_batch_size_like",
     {"Input": np.zeros((4000, 3), "float32")},
     {"shape": [-1, 50], "min": -2.0, "max": 3.0, "dtype": "float32"}),
    ("gaussian_random_batch_size_like",
     {"Input": np.zeros((3, 4000), "float32")},
     {"shape": [50, -1], "input_dim_idx": 1, "output_dim_idx": 1,
      "mean": 1.5, "std": 0.5, "dtype": "float32"}),
]


@pytest.mark.parametrize("op_type,inputs,attrs", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_random_op_distribution(op_type, inputs, attrs):
    """Same program; both packages' draws have the batch dim copied, the
    range and the first two moments within 1% of the distribution's; a
    second run of the same seed gives the port the same numbers."""
    want_prog, (want,), _ = one_op(fluid, op_type, inputs, attrs,
                                   {"Out": 1}, (), seed=7)
    got_prog, (got,), _ = one_op(pt, op_type, inputs, attrs, {"Out": 1}, (),
                                 seed=7)
    _, (again,), _ = one_op(pt, op_type, inputs, attrs, {"Out": 1}, (),
                            seed=7)
    assert got_prog == want_prog
    np.testing.assert_array_equal(got, again)
    assert got.shape == want.shape and got.size == 200000
    for a in (got, want):
        if "min" in attrs:
            lo, hi = attrs["min"], attrs["max"]
            assert lo <= a.min() and a.max() < hi
            mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        else:
            mean, var = attrs["mean"], attrs["std"] ** 2
        assert abs(a.mean() - mean) < 0.01 * max(abs(mean), 1.0)
        assert abs(a.var() - var) < 0.01 * var


def test_truncated_gaussian_random_distribution():
    """Within two standard deviations of the mean, in both packages, with
    the truncated normal's variance (0.774 std^2) within 2%."""
    attrs = {"shape": [4000, 50], "mean": -1.0, "std": 2.0,
             "dtype": "float32"}
    want_prog, (want,), _ = one_op(fluid, "truncated_gaussian_random", {},
                                   attrs, {"Out": 1}, (), seed=9)
    got_prog, (got,), _ = one_op(pt, "truncated_gaussian_random", {}, attrs,
                                 {"Out": 1}, (), seed=9)
    assert got_prog == want_prog
    var = 0.7737413 * 4.0
    for a in (got, want):
        assert -5.0 <= a.min() and a.max() <= 3.0
        assert abs(a.mean() + 1.0) < 0.02
        assert abs(a.var() - var) < 0.02 * var


def test_sampling_id_distribution():
    """Each row's id is drawn with its probability: 4000 rows of one
    distribution give frequencies within 0.03 of it in both packages."""
    p = np.asarray([0.1, 0.5, 0.0, 0.3, 0.1], "float32")
    x = np.tile(p, (4000, 1))
    want_prog, (want,), _ = one_op(fluid, "sampling_id", {"X": x}, {},
                                   {"Out": 1}, (), seed=3)
    got_prog, (got,), _ = one_op(pt, "sampling_id", {"X": x}, {},
                                 {"Out": 1}, (), seed=3)
    assert got_prog == want_prog
    assert got.dtype == np.int64 and got.shape == (4000,)
    for ids in (got, want):
        freq = np.bincount(ids, minlength=5) / len(ids)
        assert np.abs(freq - p).max() < 0.03, freq
        assert freq[2] == 0.0


def test_random_crop_windows():
    """Every plane of the output (an instance's channel) is a window of
    its input at an offset in [0, dim - size]; over 4000 planes each
    offset of each dim turns up with frequency within 0.04 of uniform, in
    both packages; the ``Seed`` passes through as ``SeedOut``."""
    n, h, w = 2000, 5, 7
    x = np.arange(n * 2 * h * w, dtype="float32").reshape(n, 2, h, w)
    seed = np.asarray([11], "int64")
    attrs = {"shape": [3, 4], "startup_seed": 0}
    outs = {"Out": 1, "SeedOut": 1}
    want_prog, (want, wseed), _ = one_op(fluid, "random_crop",
                                         {"X": x, "Seed": seed}, attrs,
                                         outs, ())
    got_prog, (got, gseed), _ = one_op(pt, "random_crop",
                                       {"X": x, "Seed": seed}, attrs, outs,
                                       ())
    assert got_prog == want_prog
    assert int(gseed[0]) == int(wseed[0]) == 11
    planes = x.reshape(2 * n, h, w)
    for out in (got, want):
        assert out.shape == (n, 2, 3, 4)
        # each (instance, channel) plane is cropped at offsets of its own
        out = out.reshape(2 * n, 3, 4)
        first = (out[:, 0, 0] - planes[:, 0, 0]).astype(int)
        oh, ow = first // w, first % w
        # the window is whole: each row and column where the offsets say
        window = planes[np.arange(2 * n)[:, None, None],
                        oh[:, None, None] + np.arange(3)[:, None],
                        ow[:, None, None] + np.arange(4)]
        np.testing.assert_array_equal(out, window)
        for off, size in ((oh, h - 3 + 1), (ow, w - 4 + 1)):
            freq = np.bincount(off, minlength=size) / (2 * n)
            assert len(freq) == size
            assert np.abs(freq - 1.0 / size).max() < 0.04, freq


def test_print_op_writes_every_run(capsys):
    """``print`` passes its input through and prints the message, name,
    shape, dtype and value at each run; ``print_grad`` prints the
    cotangent in the BACKWARD phase and passes it on."""
    x = np.asarray([[1.5, -2.0]], "float32")
    got = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            v = pkg.layers.data("x", shape=[1, 2], append_batch_size=False)
            v.stop_gradient = False
            out = pkg.layers.Print(v, message="hello", print_phase="both")
            loss = pkg.layers.mean(pkg.layers.scale(out, scale=3.0))
            pkg.backward.append_backward(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=pkg.Scope())
        capsys.readouterr()
        scope = pkg.Scope()
        res = [np.asarray(r) for r in exe.run(
            main, feed={"x": x}, fetch_list=[out, "x@GRAD"], scope=scope)]
        if pkg is fluid:
            import jax

            jax.effects_barrier()
        got[pkg.__name__] = (main.to_dict(), res, capsys.readouterr().out)
    (want_prog, want, _), (prog, res, text) = got["paddle_tpu"], \
        got["paddle_tpu_torch"]
    assert prog == want_prog
    for g, w in zip(res, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    lines = [ln for ln in text.splitlines() if ln.startswith("hello")]
    assert len(lines) == 2, text
    assert re.search(r"hello x shape=\(1, 2\) dtype=float32 "
                     r"value=\[\[ 1\.5 -2\. \]\]", lines[0]), lines[0]
    assert "print_0.tmp_0@GRAD" in lines[1] and "1.5" in lines[1], lines


def test_print_entry_is_never_captured():
    """An executor entry holding a live ``print`` is marked to run eagerly
    every time (a CUDA graph would print once); one whose ``print`` only
    prints the backward, and whose backward is not in the program, is
    not."""
    def program(phase):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            v = pt.layers.data("x", shape=[2])
            out = pt.layers.Print(v, print_phase=phase)
        return main, out

    exe = pt.Executor(pt.CPUPlace())
    marked = []
    for phase in ("forward", "backward"):
        main, out = program(phase)
        exe.run(main, feed={"x": np.ones((1, 2), "float32")},
                fetch_list=[out], scope=pt.Scope())
        marked.append(any(k[0] == id(main) for k in exe._host_entries))
    assert marked == [True, False]
    assert registry.calls_host(main.global_block().ops[0]) is False


def test_shape_and_is_empty_read_nothing_on_the_host():
    """``shape`` and ``is_empty`` answer from the input's shape: a device
    value is never read (the kernels would be the same in a capture)."""
    import torch

    x = torch.zeros(2, 0, 3)
    ctx = registry.ComputeContext(torch.device("cpu"), None)
    shape = registry.get_op_def("shape").compute({"Input": [x]}, {}, ctx, 0)
    empty = registry.get_op_def("is_empty").compute({"X": [x]}, {}, ctx, 0)
    assert shape["Out"].tolist() == [2, 0, 3]
    assert shape["Out"].dtype == torch.int64
    assert empty["Out"].tolist() == [True]


# -- the sweep: every forward op type of the port has a parity case ---------

# the op types still to port (none: ``pipeline_region`` was the last)
STILL_TO_PORT = set()

# op types whose parity cases reach them only through a layer of another
# name (the test files name the layer)
THROUGH_LAYERS = {
    "gru": "dynamic_gru", "lstmp": "dynamic_lstmp",
    "sparse_weight_decay": "L2Decay", "piecewise_lr": "piecewise_decay",
}


def _staged_fc(pkg, stages=2, microbatches=2, size=8, rate=0.0):
    """A ``layers.Pipeline`` region of ``stages`` fc + tanh stages (and a
    dropout each when ``rate``) over x, its loss mean(out^2) under SGD."""
    x = pkg.layers.data("x", shape=[size])
    pipe = pkg.layers.Pipeline(microbatches=microbatches)
    for i in range(stages):
        with pipe.stage():
            c = pipe.carry(x if i == 0 else None)
            c = pkg.layers.fc(c, size=size, act="tanh")
            if rate:
                c = pkg.layers.dropout(c, dropout_prob=rate)
            pipe.emit(c)
    out = pipe()
    loss = pkg.layers.mean(pkg.layers.square(out))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_pipeline_region_follows_jax():
    """``pipeline_region`` against the JAX op: the staged program
    serializes alike, and three SGD steps from the JAX startup state give
    the JAX losses and weights (the sequential path on one device)."""
    from paddle_tpu_torch.convert import load_numpy_state

    progs, runs = {}, {}
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(8, 8).astype("float32")} for _ in range(3)]
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss = _staged_fc(pkg, stages=3, microbatches=4)
        progs[pkg.__name__] = main.to_dict()
        names = sorted(v.name for v in startup.list_vars()
                       if v.persistable)
        if pkg is fluid:
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            state = {n: np.array(scope.find_var(n), copy=True)
                     for n in names}
        else:
            scope = pt.Scope()
            load_numpy_state(scope, startup, state, "cpu")
            exe = pt.Executor(pt.CPUPlace())
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]).ravel()[0])
                  for f in feeds]
        runs[pkg.__name__] = (losses, {n: np.asarray(scope.find_var(n))
                                       for n in names})
    assert progs["paddle_tpu"] == progs["paddle_tpu_torch"]
    ops = [op["type"] for op in progs["paddle_tpu_torch"]["blocks"][0]
           ["ops"]]
    assert ops.count("pipeline_region") == 1
    assert ops.count("pipeline_region_grad") == 1
    np.testing.assert_allclose(runs["paddle_tpu_torch"][0],
                               runs["paddle_tpu"][0], rtol=1e-5)
    for n, want in runs["paddle_tpu"][1].items():
        np.testing.assert_allclose(runs["paddle_tpu_torch"][1][n], want,
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def _names_in_port_tests():
    """Every string constant and every name and attribute in the port's
    parity tests (``tests/test_torch_*.py``)."""
    names = set()
    tests = os.path.join(ROOT, "tests")
    for f in sorted(os.listdir(tests)):
        if not (f.startswith("test_torch_") and f.endswith(".py")):
            continue
        with open(os.path.join(tests, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                names.add(node.value)
            elif isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Name):
                names.add(node.id)
    return names


def test_every_forward_op_type_has_a_parity_case():
    import paddle_tpu.registry as jax_registry

    from paddle_tpu_torch.parallel.collective import PLAN_OPS

    # the mesh runtime's collectives are the plan's own ops, inserted into
    # the program a rank runs; no program builds them
    types = sorted(t for t in registry.OPS
                   if not t.endswith("_grad") and t not in PLAN_OPS)
    jax_types = {t for t in jax_registry.OPS if not t.endswith("_grad")}
    assert len(types) == 254
    assert set(types) <= jax_types
    assert jax_types - set(types) == STILL_TO_PORT
    assert len(STILL_TO_PORT) == 0
    plain = {c.values[0] for c in CASES} | {c[0] for c in RANDOM_CASES[2:]} \
        | {"sampling_id", "random_crop", "print"}
    assert len(plain) == 58
    names = _names_in_port_tests()
    missing = [t for t in types
               if t not in names and THROUGH_LAYERS.get(t) not in names]
    assert not missing, missing
