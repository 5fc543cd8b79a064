"""The new op types of the sequence family and of the control-flow
family held against the JAX package on the CPU, one op at a time, and the
sequence layers and ``nets`` composites that build them.

Each op runs as a one-op program in both packages
(``test_torch_plain_ops.one_op``): the programs serialize alike, float
outputs agree within rtol 1e-5 / atol 1e-5, bool and integer outputs by
value (the port keeps int64 where the JAX package's x64-less ints are
int32), the gradients of ``mean(Out * w)`` with respect to every floating
input the JAX op differentiates within relative L2 1e-5.  The cases hold
the edges the ops hinge on: ragged and zero lengths, ``sequence_scatter``'s
repeated, negative and out-of-row ids, ``sequence_erase`` emptying a row,
ties in the rank table, an array index past the capacity.  No case reads
a value on the host.  The layer programs (those of
``tests/test_sequence_ops.py`` and ``tests/test_sequence_pad_ops.py``, and
``glu``, ``scaled_dot_product_attention``, ``sequence_conv_pool``) build
the JAX builders' programs and give their values."""

import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_plain_ops import _same_values, one_op, rel_l2
from test_torch_rnn import rand, run_both
from test_torch_serving import fresh_torch_programs  # noqa: F401


def _case(op_type, inputs, attrs=None, outputs=None, diff=(), id=None):
    return pytest.param(op_type, inputs, attrs or {}, outputs or {"Out": 1},
                        diff, id=id or op_type)


def _zero_tails(x, lens):
    x = x.copy()
    for i, ln in enumerate(lens):
        x[i, ln:] = 0
    return x


def _cases():
    rng = np.random.RandomState(0)
    lens = np.asarray([3, 5, 0, 4], "int32")
    x = _zero_tails(rand(rng, 4, 5, 6), lens)
    lens_b = np.asarray([2, 1, 4, 0], "int32")
    xb = _zero_tails(rand(rng, 4, 4, 6), lens_b)
    ids = np.asarray([[1, 2, 3, 2, 1], [2, 2, 2, 2, 2], [5, 0, 0, 0, 0],
                      [1, 5, 2, 5, 0]], "int64")
    ids_len = np.asarray([5, 5, 1, 4], "int32")
    table = np.asarray([[1, 5], [3, 4], [0, 3], [2, 0]], "int64")
    pre_ids = np.asarray([[3, 0, 2], [1, 4, 0]], "int64")
    beam_scores = np.log(rng.dirichlet(np.ones(7), size=(2, 3))
                         .astype("float32")).astype("float32")
    return [
        _case("sequence_mask", {"X": lens}, {"maxlen": 6,
                                             "out_dtype": "float32"},
              outputs={"Y": 1}),
        _case("sequence_mask", {"X": lens.astype("int64")},
              {"maxlen": 4, "out_dtype": "int32"}, outputs={"Y": 1},
              id="sequence_mask_int32"),
        _case("sequence_concat", {"X": [x, xb], "Length": [lens, lens_b]},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("sequence_conv", {"X": x, "Filter": rand(rng, 18, 4),
                                "Length": lens},
              {"contextLength": 3, "contextStart": -1},
              diff=("X", "Filter")),
        _case("sequence_conv", {"X": x, "Filter": rand(rng, 24, 3),
                                "Length": lens},
              {"contextLength": 4, "contextStart": -2}, diff=("X", "Filter"),
              id="sequence_conv_ctx4"),
        _case("row_conv", {"X": x, "Filter": rand(rng, 3, 6),
                           "Length": lens}, diff=("X", "Filter")),
        _case("sequence_erase", {"X": ids, "Length": ids_len},
              {"tokens": [2]}, outputs={"Out": 1, "OutLength": 1}),
        _case("sequence_erase", {"X": ids[:, :, None], "Length": ids_len},
              {"tokens": [2, 5]}, outputs={"Out": 1, "OutLength": 1},
              id="sequence_erase_b_t_1"),
        _case("sequence_enumerate", {"X": ids, "Length": ids_len},
              {"win_size": 3, "pad_value": 9}),
        _case("sequence_slice", {"X": x, "Offset": np.asarray(
            [[1], [0], [0], [2]], "int64"), "Size": np.asarray(
            [[2], [5], [0], [2]], "int64"), "Length": lens},
            outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("sequence_reverse", {"X": x, "Length": lens}, diff=("X",)),
        _case("causal_mask", {"Ref": x}, {"mask_value": -1e9,
                                          "dtype": "float32"}),
        _case("causal_mask", {}, {"seq_len": 4, "mask_value": -3.0,
                                  "dtype": "float32"},
              id="causal_mask_seq_len"),
        _case("padding_attn_bias", {"Length": lens, "Ref": x},
              {"mask_value": -1e9, "dtype": "float32"}),
        _case("sequence_pad", {"X": x, "Length": lens,
                               "PadValue": np.asarray([-2.5], "float32")},
              {"padded_length": 7}, outputs={"Out": 1, "SeqLength": 1},
              diff=("X",)),
        _case("sequence_pad", {"X": x, "Length": lens},
              {"padded_length": 3}, outputs={"Out": 1, "SeqLength": 1},
              diff=("X",), id="sequence_pad_cut"),
        _case("sequence_unpad", {"X": rand(rng, 4, 5, 6), "Length": lens},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("sequence_reshape", {"X": x, "Length": lens},
              {"new_dim": 3}, outputs={"Out": 1, "OutLength": 1},
              diff=("X",)),
        _case("sequence_expand_as", {"X": rand(rng, 4, 6), "Y": x,
                                     "YLength": lens},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("sequence_scatter", {
            "X": rand(rng, 2, 6),
            "Ids": np.asarray([[1, 3, 1, -1, 8], [0, 5, 0, 6, -7]],
                              "int64")[:, :, None],
            "Updates": rand(rng, 2, 5, 1),
            "Length": np.asarray([5, 4], "int32")},
            diff=("X", "Updates")),
        _case("im2sequence", {"X": rand(rng, 2, 3, 6, 7)},
              {"kernels": [2, 3], "strides": [2, 1],
               "paddings": [1, 0, 0, 2]},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("lod_reset", {"X": x, "Y": np.asarray([0, 2, 2, 7, 8],
                                                    "int64")},
              outputs={"Out": 1, "Length": 1}, diff=("X",)),
        _case("lod_reset", {"X": x}, {"target_lod": [0, 1, 4, 4, 9]},
              outputs={"Out": 1, "Length": 1}, id="lod_reset_target"),
        _case("lod_rank_table", {"Length": np.asarray([2, 4, 3, 4, 0],
                                                      "int64")}),
        _case("max_sequence_len", {"RankTable": table}),
        _case("reorder_lod_tensor_by_rank", {"X": x, "RankTable": table},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("lod_tensor_to_array", {"X": x, "RankTable": table},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("array_to_lod_tensor", {"X": rand(rng, 5, 4, 6),
                                      "RankTable": table},
              outputs={"Out": 1, "OutLength": 1}, diff=("X",)),
        _case("array_write", {"X": rand(rng, 3, 2), "I": np.asarray(
            [1], "int64"), "Array": rand(rng, 4, 3, 2)}, diff=("X",
                                                              "Array")),
        _case("array_write", {"X": rand(rng, 3, 2), "I": np.asarray(
            [7], "int64")}, {"capacity": 4}, diff=("X",),
            id="array_write_new_clamped"),
        _case("array_read", {"Array": rand(rng, 4, 3, 2), "I": np.asarray(
            [2], "int64")}, diff=("Array",)),
        _case("array_read", {"Array": rand(rng, 4, 3, 2), "I": np.asarray(
            [-3], "int64")}, diff=("Array",), id="array_read_clamped"),
        _case("lod_array_length", {"X": rand(rng, 4, 3, 2)}),
        _case("split_lod_tensor", {"X": rand(rng, 4, 3), "Mask": np.asarray(
            [[True], [False], [True], [True]])},
            outputs={"OutTrue": 1, "OutFalse": 1}, diff=("X",)),
        _case("merge_lod_tensor", {"Mask": np.asarray(
            [[True], [False], [True], [False]]), "InTrue": rand(rng, 4, 3),
            "InFalse": rand(rng, 4, 3)}, diff=("InTrue", "InFalse")),
        _case("beam_search", {"PreIds": pre_ids, "PreScores": rand(rng, 2, 3),
                              "Scores": beam_scores},
              {"beam_size": 3, "end_id": 0},
              outputs={"SelectedIds": 1, "SelectedScores": 1,
                       "ParentIdx": 1}),
        _case("beam_search_decode", {
            "Ids": rng.randint(0, 9, (5, 2, 3)).astype("int64"),
            "Parents": rng.randint(0, 3, (5, 2, 3)).astype("int64"),
            "Scores": rand(rng, 2, 3)}, {"beam_size": 3, "end_id": 0},
            outputs={"SentenceIds": 1, "SentenceScores": 1}),
    ]


CASES = _cases()

# the 31 op types of this family: each has a case above or a program in
# tests/test_torch_control_flow.py (``while``, ``conditional_block``)
TYPES = {c.values[0] for c in CASES} | {"while", "conditional_block"}


def test_the_family_is_whole():
    assert len(TYPES) == 31


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_follows_jax(op_type, inputs, attrs, outputs, diff):
    want_prog, want, want_g = one_op(fluid, op_type, inputs, attrs,
                                     outputs, diff)
    got_prog, got, got_g = one_op(pt, op_type, inputs, attrs, outputs,
                                  diff)
    assert got_prog == want_prog
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if g.dtype.kind in "biu" or w.dtype.kind in "biu":
            assert _same_values(g, w), (i, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg="output %d" % i)
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert rel_l2(g, w) <= 1e-5, (i, rel_l2(g, w))


# ``lod_reset``'s target_lod attr becomes a device constant once
# (``ops/creation.device_constant``): a copy of host data, no read
HOST_CONSTANTS = {("lod_reset", "torch.from_numpy")}


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_reads_nothing_on_the_host(host_read_guard, op_type, inputs,
                                      attrs, outputs, diff):
    one_op(pt, op_type, inputs, attrs, outputs, diff)
    assert set(host_read_guard) <= HOST_CONSTANTS, host_read_guard


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

LENS = np.asarray([3, 5, 1, 4], "int32")


def _seq_data(pkg, name, d, dtype="float32"):
    v = pkg.layers.data(name, shape=[d], dtype=dtype, lod_level=1)
    v.stop_gradient = False
    return v


def _grad(pkg, loss, xs):
    return pkg.backward.calc_gradient(loss, xs)


def seq_layers(pkg):
    """The per-step sequence layers chained on one padded batch, and the
    gradient reaching the input."""
    L = pkg.layers
    x = _seq_data(pkg, "x", 6)
    conv = L.sequence_conv(x, num_filters=5, filter_size=3, act="tanh")
    rc = L.row_conv(conv, future_context_size=2)
    rev = L.sequence_reverse(rc)
    cat = L.sequence_concat([rev, conv])
    pooled = L.sequence_pool(cat, "sum")
    pad, plen = L.sequence_pad(rev, maxlen=7)
    mask = L.sequence_mask(plen, maxlen=7, dtype="float32")
    bias = L.padding_attn_bias(L.sequence_length(x), x)
    causal = L.causal_mask(ref=x)
    loss = L.reduce_sum(pooled) + L.reduce_sum(L.square(pad))
    (gx,) = _grad(pkg, loss, [x])
    return [pooled, pad, plen, mask, bias, causal, gx]


def test_sequence_layers_build_and_follow_jax():
    rng = np.random.RandomState(1)
    feed = {"x": _zero_tails(rand(rng, 4, 5, 6), LENS), "x@LEN": LENS}
    run_both(seq_layers, [feed], fwd=6)


def id_layers(pkg):
    L = pkg.layers
    ids = pkg.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
    erased = L.sequence_erase(ids, tokens=[2])
    enum = L.sequence_enumerate(erased, win_size=2, pad_value=0)
    return [erased, L.sequence_length(erased), enum]


def test_id_layers_build_and_follow_jax():
    feed = {"ids": np.asarray([[1, 2, 3, 2, 1], [2, 2, 2, 2, 2],
                               [5, 0, 0, 0, 0], [1, 5, 2, 5, 0]],
                              "int64")[:, :, None],
            "ids@LEN": np.asarray([5, 5, 1, 4], "int32")}
    (got,), _, _ = run_both(id_layers, [feed])
    assert got[1].tolist() == [3, 0, 1, 3]


def pad_layers(pkg):
    """``tests/test_sequence_pad_ops.py``'s layers in one program."""
    L = pkg.layers
    x = _seq_data(pkg, "x", 3)
    out, slen = L.sequence_pad(x, maxlen=6)
    dense = L.data("dense", shape=[4, 3], dtype="float32")
    ln = L.data("ln", shape=[], dtype="int32")
    seq = L.sequence_unpad(dense, ln)
    summed = L.sequence_pool(seq, "sum")
    resh = L.sequence_reshape(x, new_dim=6)
    row = L.data("row", shape=[3], dtype="float32")
    expanded = L.sequence_expand_as(row, x)
    xs = L.data("xs", shape=[6])
    si = L.data("ids", shape=[1], dtype="int64", lod_level=1)
    su = L.data("upd", shape=[1], dtype="float32", lod_level=1)
    scat = L.sequence_scatter(xs, si, su)
    img = L.data("img", shape=[3, 6, 6])
    patches = L.im2sequence(img, filter_size=2, stride=2)
    reset = L.lod_reset(x, target_lod=[0, 1, 3, 4, 8])
    loss = L.reduce_sum(L.square(out)) + L.reduce_sum(resh)
    (gx,) = _grad(pkg, loss, [x])
    return [out, slen, summed, resh, L.sequence_length(resh), expanded,
            scat, patches, L.sequence_length(patches),
            L.sequence_length(reset), gx]


def test_pad_layers_build_and_follow_jax():
    rng = np.random.RandomState(2)
    lens = np.asarray([2, 4, 1, 3], "int32")
    feed = {"x": _zero_tails(rand(rng, 4, 4, 3), lens), "x@LEN": lens,
            "dense": rand(rng, 4, 4, 3), "ln": lens,
            "row": rand(rng, 4, 3), "xs": np.zeros((4, 6), "float32"),
            "ids": np.asarray([[1, 3, 1], [0, 5, 0], [2, 2, 2], [4, 1, 0]],
                              "int64")[:, :, None],
            "ids@LEN": np.asarray([3, 2, 3, 0], "int32"),
            "upd": rand(rng, 4, 3, 1),
            "upd@LEN": np.asarray([3, 2, 3, 0], "int32"),
            "img": rand(rng, 4, 3, 6, 6)}
    (got,), _, _ = run_both(pad_layers, [feed], fwd=10)
    assert got[7].shape == (4, 9, 12)
    assert got[9].tolist() == [1, 2, 1, 4]


def rank_layers(pkg):
    """``tests/test_sequence_ops.py``'s rank-table family and tensor-array
    round trip."""
    L = pkg.layers
    x = _seq_data(pkg, "x", 2)
    table = L.lod_rank_table(x)
    maxlen = L.max_sequence_len(table)
    reordered = L.reorder_lod_tensor_by_rank(x, table)
    relen = L.sequence_length(reordered)
    arr = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(arr, table)
    loss = L.mean(L.sequence_pool(reordered, "sum")) + L.mean(back)
    (gx,) = _grad(pkg, loss, [x])
    return [table, maxlen, reordered, relen, arr, back,
            L.sequence_length(back), gx]


def test_rank_layers_build_and_follow_jax():
    feed = {"x": np.arange(24, dtype="float32").reshape(3, 4, 2),
            "x@LEN": np.asarray([2, 4, 3], "int64")}
    (got,), _, _ = run_both(rank_layers, [feed], fwd=7)
    np.testing.assert_array_equal(got[0], [[1, 4], [2, 3], [0, 2]])
    assert got[1].shape == () and int(got[1]) == 4
    np.testing.assert_array_equal(got[5], feed["x"])


def nets_composites(pkg):
    L = pkg.layers
    x = _seq_data(pkg, "x", 6)
    pooled = pkg.nets.sequence_conv_pool(x, num_filters=4, filter_size=3)
    g = pkg.nets.glu(L.data("g", shape=[8]))
    q = L.data("q", shape=[5, 8])
    k = L.data("k", shape=[7, 8])
    att = pkg.nets.scaled_dot_product_attention(q, k, k, num_heads=2)
    loss = L.reduce_sum(pooled) + L.reduce_sum(att)
    (gx,) = _grad(pkg, loss, [x])
    return [pooled, g, att, gx]


def test_nets_composites_build_and_follow_jax():
    rng = np.random.RandomState(3)
    feed = {"x": _zero_tails(rand(rng, 4, 5, 6), LENS), "x@LEN": LENS,
            "g": rand(rng, 4, 8), "q": rand(rng, 4, 5, 8),
            "k": rand(rng, 4, 7, 8)}
    run_both(nets_composites, [feed], fwd=3)


@pytest.mark.parametrize("build", [seq_layers, id_layers, pad_layers,
                                   rank_layers, nets_composites],
                         ids=lambda f: f.__name__)
def test_layer_programs_read_nothing_on_the_host(host_read_guard, build):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        fetch = build(pt)
    rng = np.random.RandomState(0)
    block = main.global_block()
    feed = {}
    for v in block.vars.values():
        if v.is_data:
            shape = [4 if s == -1 else s for s in v.shape]
            if v.name.endswith("@LEN") or v.name == "ln":
                feed[v.name] = np.asarray([2, 1, 0, 3][:shape[0]], "int32")
            elif v.dtype is not None and not v.dtype.is_floating_point:
                feed[v.name] = rng.randint(0, 3, shape).astype("int64")
            else:
                feed[v.name] = rng.rand(*shape).astype("float32")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert set(host_read_guard) <= HOST_CONSTANTS, host_read_guard
