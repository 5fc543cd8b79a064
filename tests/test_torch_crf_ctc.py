"""The CRF and CTC op families held against the JAX package on the CPU:
``linear_chain_crf``, ``crf_decoding``, ``chunk_eval``, ``warpctc``,
``ctc_align`` and ``edit_distance`` as one-op programs
(``test_torch_plain_ops.one_op``), and their layers (``linear_chain_crf``,
``crf_decoding``, ``chunk_eval``, ``warpctc``, ``ctc_greedy_decoder``,
``edit_distance``), ``ChunkEvaluator`` and ``EditDistance``.

The programs serialize alike; integer outputs agree by value (the port's
int64 against the JAX package's int32), float forwards within rtol 1e-5,
and the gradients through the CRF and CTC recursions within relative L2
1e-4 of ``jax.vjp``'s.  The cases hold the edges: a sequence of length 1
and of length 0, a CTC label as long as its input whose repeated token
needs a blank it cannot have (the loss at the -1e30 floor, where the
gradient follows ``jnp.logaddexp``'s), Viterbi and greedy-decoding ties
planted to break at the first index, each chunk scheme with excluded
types.  No op reads a value on the host."""

import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_plain_ops import _same_values, one_op, rel_l2
from test_torch_rnn import rand, run_both
from test_torch_serving import fresh_torch_programs  # noqa: F401

# gradients through a T-step recursion: relative L2 against jax.vjp's
RECURSION_GRAD = 1e-4


def _case(op_type, inputs, attrs=None, outputs=None, diff=(), id=None):
    return pytest.param(op_type, inputs, attrs or {}, outputs or {"Out": 1},
                        diff, id=id or op_type)


def _tags(rng, b, t, n):
    return rng.randint(0, n, (b, t, 1)).astype("int64")


def _cases():
    rng = np.random.RandomState(0)
    b, t, d = 4, 6, 5
    lens = np.asarray([6, 1, 4, 0], "int32")
    emission = rand(rng, b, t, d)
    transition = rand(rng, d + 2, d, scale=0.5)
    label = _tags(rng, b, t, d)
    # ties: equal emissions and transitions everywhere (every path scores
    # alike), and a row of equal emissions under a random transition
    flat_e = np.zeros((2, 4, 3), "float32")
    flat_t = np.zeros((5, 3), "float32")
    tie_e = rand(rng, 2, 4, 3)
    tie_e[0, 2] = tie_e[0, 2, 0]
    tie_t = np.round(rand(rng, 5, 3), 0).astype("float32")
    # chunk tags: IOB over 3 types (tags 0..5, 6 = O), IOBES over 2 types
    inf_iob = rng.randint(0, 7, (3, 9, 1)).astype("int64")
    lab_iob = inf_iob.copy()
    lab_iob[0, 3] = 6
    lab_iob[2, 1:4] = [[0], [1], [1]]
    chunk_lens = np.asarray([9, 5, 7], "int32")
    inf_es = rng.randint(0, 9, (3, 9, 1)).astype("int64")
    lab_es = np.where(rng.rand(3, 9, 1) < 0.7, inf_es,
                      rng.randint(0, 9, (3, 9, 1))).astype("int64")
    # CTC: logits [4, 7, 5] (blank 0), labels up to 4; sequence 2 has a
    # label as long as its input with a repeat that needs a blank
    logits = rand(rng, 4, 7, 5)
    t_len = np.asarray([7, 5, 3, 1], "int32")
    ctc_lbl = np.asarray([[1, 2, 2, 3], [4, 4, 0, 0], [2, 2, 3, 0],
                          [3, 0, 0, 0]], "int64")[:, :, None]
    ctc_len = np.asarray([4, 2, 3, 1], "int32")
    ids = np.asarray([[1, 1, 0, 2, 2, 0, 3], [0, 0, 4, 4, 4, 1, 0],
                      [2, 0, 2, 0, 2, 2, 1], [1, 2, 3, 4, 1, 2, 3]],
                     "int64")[:, :, None]
    hyp = rng.randint(0, 4, (4, 6)).astype("int64")
    ref = rng.randint(0, 4, (4, 5)).astype("int64")
    hyp[1] = [1, 2, 3, 0, 0, 0]
    ref[1, :3] = [1, 2, 3]
    return [
        _case("linear_chain_crf", {"Emission": emission, "Length": lens,
                                   "Transition": transition,
                                   "Label": label},
              outputs={"LogLikelihood": 1},
              diff=("Emission", "Transition")),
        _case("linear_chain_crf", {"Emission": emission[:, :1],
                                   "Length": np.asarray([1, 1, 0, 1],
                                                        "int32"),
                                   "Transition": transition,
                                   "Label": label[:, :1, 0]},
              outputs={"LogLikelihood": 1},
              diff=("Emission", "Transition"), id="linear_chain_crf_t1"),
        _case("crf_decoding", {"Emission": emission, "Length": lens,
                               "Transition": transition},
              outputs={"ViterbiPath": 1}),
        _case("crf_decoding", {"Emission": emission, "Length": lens,
                               "Transition": transition, "Label": label},
              outputs={"ViterbiPath": 1}, id="crf_decoding_label"),
        _case("crf_decoding", {"Emission": flat_e, "Length": np.asarray(
            [4, 3], "int32"), "Transition": flat_t},
            outputs={"ViterbiPath": 1}, id="crf_decoding_all_tied"),
        _case("crf_decoding", {"Emission": tie_e, "Length": np.asarray(
            [4, 4], "int32"), "Transition": tie_t},
            outputs={"ViterbiPath": 1}, id="crf_decoding_ties"),
        _case("chunk_eval", {"Inference": inf_iob, "Label": lab_iob,
                             "Length": chunk_lens},
              {"num_chunk_types": 3, "chunk_scheme": "IOB"},
              outputs={s: 1 for s in ("Precision", "Recall", "F1-Score",
                                      "NumInferChunks", "NumLabelChunks",
                                      "NumCorrectChunks")}),
        _case("chunk_eval", {"Inference": inf_iob, "Label": lab_iob,
                             "Length": chunk_lens},
              {"num_chunk_types": 3, "chunk_scheme": "IOE",
               "excluded_chunk_types": [1]},
              outputs={s: 1 for s in ("Precision", "Recall", "F1-Score",
                                      "NumInferChunks", "NumLabelChunks",
                                      "NumCorrectChunks")},
              id="chunk_eval_ioe_excluded"),
        _case("chunk_eval", {"Inference": inf_es, "Label": lab_es,
                             "Length": chunk_lens},
              {"num_chunk_types": 2, "chunk_scheme": "IOBES"},
              outputs={s: 1 for s in ("Precision", "Recall", "F1-Score",
                                      "NumInferChunks", "NumLabelChunks",
                                      "NumCorrectChunks")},
              id="chunk_eval_iobes"),
        _case("chunk_eval", {"Inference": inf_es[:, :, 0] % 4,
                             "Label": lab_es[:, :, 0] % 4,
                             "Length": chunk_lens},
              {"num_chunk_types": 3, "chunk_scheme": "plain"},
              outputs={s: 1 for s in ("Precision", "Recall", "F1-Score",
                                      "NumInferChunks", "NumLabelChunks",
                                      "NumCorrectChunks")},
              id="chunk_eval_plain"),
        _case("warpctc", {"Logits": logits, "LogitsLength": t_len,
                          "Label": ctc_lbl, "LabelLength": ctc_len},
              outputs={"Loss": 1}, diff=("Logits",)),
        _case("warpctc", {"Logits": logits, "LogitsLength": t_len,
                          "Label": ctc_lbl, "LabelLength": ctc_len},
              {"norm_by_times": True, "blank": 4}, outputs={"Loss": 1},
              diff=("Logits",), id="warpctc_norm_blank4"),
        _case("ctc_align", {"Input": ids, "Length": np.asarray(
            [7, 6, 0, 5], "int32")}, {"blank": 0},
            outputs={"Output": 1, "OutputLength": 1}),
        _case("ctc_align", {"Input": ids[:, :, 0], "Length": np.asarray(
            [7, 7, 7, 7], "int32")}, {"blank": 2, "merge_repeated": False},
            outputs={"Output": 1, "OutputLength": 1},
            id="ctc_align_no_merge"),
        _case("edit_distance", {"Hyps": hyp, "HypsLength": np.asarray(
            [6, 3, 0, 4], "int32"), "Refs": ref, "RefsLength": np.asarray(
            [5, 3, 2, 0], "int32")}, outputs={"Out": 1, "SequenceNum": 1}),
        _case("edit_distance", {"Hyps": hyp[:, :, None],
                                "HypsLength": np.asarray([2, 6, 1, 5],
                                                         "int32"),
                                "Refs": ref[:, :, None],
                                "RefsLength": np.asarray([5, 4, 1, 3],
                                                         "int32")},
              {"normalized": False}, outputs={"Out": 1, "SequenceNum": 1},
              id="edit_distance_raw"),
    ]


CASES = _cases()


def _compare(got, want, got_g, want_g, grad_band):
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
        assert np.isfinite(g).all()
        assert rel_l2(g, w) <= grad_band, (i, rel_l2(g, w))


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_follows_jax(op_type, inputs, attrs, outputs, diff):
    want_prog, want, want_g = one_op(fluid, op_type, inputs, attrs,
                                     outputs, diff)
    got_prog, got, got_g = one_op(pt, op_type, inputs, attrs, outputs,
                                  diff)
    assert got_prog == want_prog
    _compare(got, want, got_g, want_g, RECURSION_GRAD)


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_reads_nothing_on_the_host(host_read_guard, op_type, inputs,
                                      attrs, outputs, diff):
    one_op(pt, op_type, inputs, attrs, outputs, diff)
    assert not host_read_guard, host_read_guard


def test_ctc_floor_and_ties_are_what_they_claim():
    """The planted edges are real: sequence 2's label cannot be aligned
    (its loss sits at the 1e30 floor, finite gradient), the others can;
    the tied Viterbi batch has several best paths and decodes to the
    first-index one, all zeros."""
    (case,) = [c for c in CASES if c.id == "warpctc"]
    _, (loss,), (grad,) = one_op(pt, *case.values)
    assert loss[2, 0] > 1e29 and (loss[[0, 1, 3], 0] < 1e3).all()
    assert np.isfinite(grad).all()
    (case,) = [c for c in CASES if c.id == "crf_decoding_all_tied"]
    _, (path,), _ = one_op(pt, *case.values)
    assert (path == 0).all()


# ---------------------------------------------------------------------------
# the layers and the evaluators
# ---------------------------------------------------------------------------

TAGS = 7          # IOB over 3 chunk types and O


def crf_layers(pkg):
    """An fc emission over a padded batch, its CRF cost (and gradients),
    the Viterbi paths and mask, and chunk_eval of the paths."""
    L = pkg.layers
    x = L.data("x", shape=[4], dtype="float32", lod_level=1)
    x.stop_gradient = False
    tag = L.data("tag", shape=[1], dtype="int64", lod_level=1)
    emission = L.fc(x, size=TAGS, num_flatten_dims=2,
                    param_attr=pkg.ParamAttr(name="emit_w"))
    cost = L.linear_chain_crf(emission, tag,
                              param_attr=pkg.ParamAttr(name="crfw"))
    path = L.crf_decoding(emission, param_attr=pkg.ParamAttr(name="crfw"))
    mask = L.crf_decoding(emission, param_attr=pkg.ParamAttr(name="crfw"),
                          label=tag)
    p, r, f1, n_inf, n_lab, n_cor = L.chunk_eval(
        path, tag, chunk_scheme="IOB", num_chunk_types=3)
    loss = L.mean(cost)
    gx, gw, gt = pkg.backward.calc_gradient(
        loss, [x, pkg.default_main_program().global_block().var("emit_w"),
               pkg.default_main_program().global_block().var("crfw")])
    return [cost, path, mask, p, r, f1, n_inf, n_lab, n_cor, gx, gw, gt]


def _crf_feed(rng, b=4, t=6):
    lens = np.asarray([6, 1, 3, 5], "int32")[:b]
    return {"x": rand(rng, b, t, 4), "x@LEN": lens,
            "tag": rng.randint(0, TAGS, (b, t, 1)).astype("int64"),
            "tag@LEN": lens}


def test_crf_layers_build_and_follow_jax():
    rng = np.random.RandomState(3)
    _, progs, _ = run_both(crf_layers, [_crf_feed(rng)], fwd=9)
    assert progs[pt][0].to_dict() == progs[fluid][0].to_dict()
    assert progs[pt][1].to_dict() == progs[fluid][1].to_dict()


def ctc_layers(pkg):
    L = pkg.layers
    x = L.data("x", shape=[5], dtype="float32", lod_level=1)
    x.stop_gradient = False
    lbl = L.data("lbl", shape=[1], dtype="int64", lod_level=1)
    logits = L.fc(x, size=5, num_flatten_dims=2)
    loss = L.warpctc(logits, lbl, blank=0)
    decoded = L.ctc_greedy_decoder(logits, blank=0)
    dist, n = L.edit_distance(decoded, lbl, ignored_tokens=[3])
    (gx,) = pkg.backward.calc_gradient(L.mean(loss), [x])
    return [loss, decoded, L.sequence_length(decoded), dist, n, gx]


def test_ctc_layers_build_and_follow_jax():
    rng = np.random.RandomState(4)
    lens = np.asarray([7, 5, 3, 2], "int32")
    feed = {"x": rand(rng, 4, 7, 5), "x@LEN": lens,
            "lbl": rng.randint(1, 5, (4, 3, 1)).astype("int64"),
            "lbl@LEN": np.asarray([3, 2, 1, 2], "int32")}
    _, progs, _ = run_both(ctc_layers, [feed], fwd=5)
    assert progs[pt][0].to_dict() == progs[fluid][0].to_dict()


def test_ctc_greedy_decoder_takes_the_first_maximum():
    """Logits tied between two classes at every step decode, in both
    packages, to the lower class (``arg_max``'s first index), so repeats
    merge and the blank (0) drops as the first-index rule says."""
    logits = np.zeros((2, 5, 4), "float32")
    logits[0, :, [0, 2]] = 1.0       # blank ties with 2: blank wins
    logits[1, :, [1, 3]] = 1.0       # 1 ties with 3: 1 wins, merged
    logits[1, 2, 3] = 2.0            # one clear 3 in the middle
    got = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32",
                                lod_level=1)
            out = pkg.layers.ctc_greedy_decoder(x, blank=0)
            fetch = [out, pkg.layers.sequence_length(out)]
        got[pkg] = pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": logits, "x@LEN": np.asarray([5, 5], "int32")},
            fetch_list=fetch)
    for g, w in zip(got[pt], got[fluid]):
        assert _same_values(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(got[pt][1], [0, 3])
    np.testing.assert_array_equal(np.asarray(got[pt][0])[1, :3],
                                  [1, 3, 1])


def _evaluator_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        inf = L.data("inf", shape=[1], dtype="int64", lod_level=1)
        lab = L.data("lab", shape=[1], dtype="int64", lod_level=1)
        chunk = pkg.evaluator.ChunkEvaluator(inf, lab, "IOB", 3)
        hyp = L.data("hyp", shape=[1], dtype="int64", lod_level=1)
        ref = L.data("ref", shape=[1], dtype="int64", lod_level=1)
        edit = pkg.evaluator.EditDistance(hyp, ref, ignored_tokens=[0])
    return main, startup, chunk, edit


def test_evaluators_accumulate_reset_and_follow_jax():
    """``ChunkEvaluator`` and ``EditDistance`` in one program: their
    programs equal the JAX package's, three batches accumulate in the
    persistable states to the same precision / recall / F1 and average
    distance / error rate, and ``reset`` zeroes them."""
    rng = np.random.RandomState(5)
    feeds = []
    for _ in range(3):
        lens = rng.randint(1, 8, 4).astype("int32")
        inf = rng.randint(0, 7, (4, 8, 1)).astype("int64")
        lab = np.where(rng.rand(4, 8, 1) < 0.6, inf,
                       rng.randint(0, 7, (4, 8, 1))).astype("int64")
        feeds.append({"inf": inf, "inf@LEN": lens, "lab": lab,
                      "lab@LEN": lens,
                      "hyp": rng.randint(0, 4, (4, 6, 1)).astype("int64"),
                      "hyp@LEN": rng.randint(0, 7, 4).astype("int32"),
                      "ref": rng.randint(0, 4, (4, 5, 1)).astype("int64"),
                      "ref@LEN": rng.randint(1, 6, 4).astype("int32")})
    res = {}
    for pkg in (fluid, pt):
        main, startup, chunk, edit = _evaluator_program(pkg)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            chunk.reset(exe)
            edit.reset(exe)
            for f in feeds:
                exe.run(main, feed=f, fetch_list=chunk.metrics)
            res[pkg] = (main.to_dict(), chunk.eval(exe), edit.eval(exe))
            chunk.reset(exe)
            edit.reset(exe)
            res[pkg] += (chunk.eval(exe), edit.eval(exe))
    assert res[pt][0] == res[fluid][0]
    for got, want in zip(res[pt][1:], res[fluid][1:]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert res[pt][1][0][0] > 0 and res[pt][2][0][0] > 0
    assert all(float(v[0]) == 0.0 for v in res[pt][3] + res[pt][4])
