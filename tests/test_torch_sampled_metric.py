"""The sampled losses and the metric ops held against the JAX package on
the CPU: ``nce``, ``hierarchical_sigmoid``, ``bilinear_tensor_product``,
``mean_iou``, ``precision_recall``, ``positive_negative_pair`` and
``detection_map`` as one-op programs (``test_torch_plain_ops.one_op``),
the layers ``nce``, ``hsigmoid``, ``bilinear_tensor_product`` and
``mean_iou``, and the ``DetectionMAP`` evaluator.

Integer outputs agree by value, floats within rtol 1e-5, gradients within
relative L2 1e-5.  ``nce`` draws its negatives from the port's generator,
so its numbers cannot be the JAX op's: the programs are equal, the port's
``Cost`` and ``SampleLogits`` (and their gradients) equal the JAX op's
compute run on the port's own ``SampleLabels``, the gradient is the one
of the forward's samples (a recompute would draw others), and the
negatives are uniform by their moments.  No op reads a value on the
host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.ops import sampled_loss as jax_sampled_loss

import paddle_tpu_torch as pt

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_plain_ops import _same_values, one_op, rel_l2
from test_torch_rnn import rand, run_both
from test_torch_serving import fresh_torch_programs  # noqa: F401


def _case(op_type, inputs, attrs=None, outputs=None, diff=(), id=None):
    return pytest.param(op_type, inputs, attrs or {}, outputs or {"Out": 1},
                        diff, id=id or op_type)


def _detections(rng, b, d, g, c):
    """([B, D, 6] detections with tied scores and -1 padding rows, [B, G,
    6] ground truths with a difficult column, their lengths)."""
    det = np.zeros((b, d, 6), "float32")
    det[..., 0] = rng.randint(0, c, (b, d))
    det[..., 1] = np.round(rng.rand(b, d), 1)           # ties
    xy = rng.rand(b, d, 2) * 0.7
    det[..., 2:4] = xy
    det[..., 4:6] = xy + 0.05 + rng.rand(b, d, 2) * 0.3
    det[0, -1, 0] = -1
    gt = np.zeros((b, g, 6), "float32")
    gt[..., 0] = rng.randint(1, c, (b, g))
    gxy = rng.rand(b, g, 2) * 0.7
    gt[..., 1:3] = gxy
    gt[..., 3:5] = gxy + 0.1 + rng.rand(b, g, 2) * 0.3
    gt[..., 5] = rng.rand(b, g) < 0.2
    # a detection on each ground truth's box, so matches happen
    det[:, :g, 0] = gt[..., 0]
    det[:, :g, 2:6] = gt[..., 1:5] + rng.randn(b, g, 4).astype(
        "float32") * 0.02
    return det, gt, np.asarray([d, d - 3, 5][:b], "int32"), \
        np.asarray([g, g - 1, 2][:b], "int32")


def _cases():
    rng = np.random.RandomState(0)
    x, y = rand(rng, 6, 5), rand(rng, 6, 4)
    det, gt, dlen, glen = _detections(rng, 3, 12, 4, 5)
    scores = np.round(rng.rand(10, 3), 1).astype("float32")   # ties
    pnp_label = rng.randint(0, 3, (10, 1)).astype("float32")
    query = rng.randint(0, 3, (10, 1)).astype("int64")
    return [
        _case("hierarchical_sigmoid", {
            "X": x, "W": rand(rng, 12, 5), "Label": np.asarray(
                [0, 3, 12, 7, 11, 5], "int64")[:, None],
            "Bias": rand(rng, 12, 1)}, {"num_classes": 13},
            diff=("X", "W", "Bias")),
        _case("hierarchical_sigmoid", {
            "X": x, "W": rand(rng, 7, 5), "Label": np.asarray(
                [0, 1, 2, 7, 4, 6], "int64")}, {"num_classes": 8},
            diff=("X", "W"), id="hierarchical_sigmoid_pow2_no_bias"),
        _case("bilinear_tensor_product", {
            "X": x, "Y": y, "Weight": rand(rng, 3, 5, 4),
            "Bias": rand(rng, 1, 3)}, diff=("X", "Y", "Weight", "Bias")),
        _case("mean_iou", {
            "Predictions": rng.randint(0, 4, (5, 6)).astype("int32"),
            "Labels": np.where(rng.rand(5, 6) < 0.5, 1, rng.randint(
                -1, 4, (5, 6))).astype("int32")},
            {"num_classes": 4},
            outputs={"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1}),
        _case("precision_recall", {
            "MaxProbs": rng.rand(10, 1).astype("float32"),
            "Indices": rng.randint(0, 4, (10, 1)).astype("int64"),
            "Labels": rng.randint(0, 4, (10, 1)).astype("int64"),
            "Weights": rng.rand(10, 1).astype("float32"),
            "StatesInfo": rng.randint(0, 5, (4, 4)).astype("float32")},
            {"class_number": 4},
            outputs={"BatchMetrics": 1, "AccumMetrics": 1,
                     "AccumStatesInfo": 1}),
        _case("precision_recall", {
            "MaxProbs": rng.rand(7, 1).astype("float32"),
            "Indices": rng.randint(0, 3, (7, 1)).astype("int64"),
            "Labels": rng.randint(0, 3, (7, 1)).astype("int64")},
            {"class_number": 5},
            outputs={"BatchMetrics": 1, "AccumMetrics": 1,
                     "AccumStatesInfo": 1}, id="precision_recall_plain"),
        _case("positive_negative_pair", {
            "Score": scores, "Label": pnp_label, "QueryID": query,
            "AccumulatePositivePair": np.asarray([2.0], "float32"),
            "AccumulateNegativePair": np.asarray([1.0], "float32"),
            "AccumulateNeutralPair": np.asarray([0.5], "float32"),
            "Weight": rng.rand(10, 1).astype("float32")}, {"column": -1},
            outputs={"PositivePair": 1, "NegativePair": 1,
                     "NeutralPair": 1}),
        _case("positive_negative_pair", {
            "Score": scores, "Label": pnp_label, "QueryID": query},
            {"column": 1}, outputs={"PositivePair": 1, "NegativePair": 1,
                                    "NeutralPair": 1},
            id="positive_negative_pair_plain"),
        _case("detection_map", {"DetectRes": det, "DetectResLength": dlen,
                                "Label": gt, "GtLength": glen},
              {"class_num": 5, "overlap_threshold": 0.5,
               "ap_type": "integral"},
              outputs={"MAP": 1, "AccumPosCount": 1}),
        _case("detection_map", {"DetectRes": det, "Label": gt},
              {"class_num": 5, "overlap_threshold": 0.3,
               "evaluate_difficult": False, "ap_type": "11point"},
              outputs={"MAP": 1, "AccumPosCount": 1},
              id="detection_map_11point_difficult"),
        _case("detection_map", {"DetectRes": det, "Label": gt[..., :5],
                                "GtLength": glen},
              {"class_num": 5, "background_label": 1,
               "ap_type": "11point"},
              outputs={"MAP": 1, "AccumPosCount": 1},
              id="detection_map_no_difficult_bg1"),
    ]


CASES = _cases()


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


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff", CASES)
def test_op_reads_nothing_on_the_host(host_read_guard, op_type, inputs,
                                      attrs, outputs, diff):
    one_op(pt, op_type, inputs, attrs, outputs, diff)
    assert not host_read_guard, host_read_guard


def test_detection_map_case_is_not_trivial():
    """The mAP case holds true and false positives of several classes
    (a mAP strictly between 0 and 1) and equal scores across images."""
    (case,) = [c for c in CASES if c.id == "detection_map"]
    _, (m, pos), _ = one_op(pt, *case.values)
    assert 0.0 < float(m[0]) < 1.0 and (pos > 0).sum() >= 3
    det = case.values[1]["DetectRes"]
    assert len(np.unique(det[..., 1])) < det[..., 1].size // 2


# ---------------------------------------------------------------------------
# nce: the JAX formula on the port's own samples
# ---------------------------------------------------------------------------

NCE = dict(b=2000, d=6, c=50, num_neg=7)


def _nce_inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, d, c = NCE["b"], NCE["d"], NCE["c"]
    return {"Input": rand(rng, b, d), "Label": rng.randint(
        0, c, (b, 2)).astype("int64"), "Weight": rand(rng, c, d, scale=0.3),
        "Bias": rand(rng, c, 1), "SampleWeight": rng.rand(b, 1).astype(
            "float32")}


NCE_ATTRS = {"num_total_classes": NCE["c"], "num_neg_samples": NCE["num_neg"],
             "num_true": 2}
NCE_OUTS = {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1}


class _Ctx:
    def rng_key(self, op_index):
        return jax.random.PRNGKey(0)


def _jax_nce(inputs, samples):
    """The JAX op's compute (``_nce_compute``) with its negatives replaced
    by ``samples``' (and the gradients of mean(Cost * w), w as
    ``one_op`` draws it)."""
    negs = jnp.asarray(samples[:, 2:].astype("int32"))
    real = jax.random.randint

    def f(x, wt, bias):
        jax.random.randint = lambda key, shape, lo, hi: negs
        try:
            out = jax_sampled_loss._nce_compute(
                {"Input": [x], "Label": [inputs["Label"]], "Weight": [wt],
                 "Bias": [bias], "SampleWeight": [inputs["SampleWeight"]]},
                NCE_ATTRS, _Ctx(), 0)
        finally:
            jax.random.randint = real
        return out

    w = np.random.RandomState(1).rand(NCE["b"], 1).astype("float32")
    out = f(inputs["Input"], inputs["Weight"], inputs["Bias"])
    grads = jax.grad(lambda *a: jnp.mean(f(*a)["Cost"] * w),
                     argnums=(0, 1, 2))(inputs["Input"], inputs["Weight"],
                                        inputs["Bias"])
    return out, grads


def test_nce_follows_the_jax_formula_on_its_own_samples():
    """Equal programs (with the backward); Cost and SampleLogits equal the
    JAX compute's on the port's SampleLabels, and so do the gradients of
    Input, Weight and Bias: the grad op saw the forward's samples."""
    inputs = _nce_inputs()
    diff = ("Input", "Weight", "Bias")
    want_prog, _, _ = one_op(fluid, "nce", inputs, NCE_ATTRS, NCE_OUTS, diff)
    got_prog, (cost, logits, samples), grads = one_op(
        pt, "nce", inputs, NCE_ATTRS, NCE_OUTS, diff)
    assert got_prog == want_prog
    np.testing.assert_array_equal(samples[:, :2], inputs["Label"])
    want, want_g = _jax_nce(inputs, samples)
    np.testing.assert_allclose(cost, np.asarray(want["Cost"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(logits, np.asarray(want["SampleLogits"]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(grads, want_g):
        assert rel_l2(g, np.asarray(w)) <= 1e-5


def test_nce_negatives_are_uniform_and_seeded():
    """The port's negatives over 2000 x 7 draws: in [0, C), mean and
    variance within 3% of the uniform's, every class drawn; a second run
    of one seed draws the same, another seed others."""
    inputs = _nce_inputs()
    runs = [one_op(pt, "nce", inputs, NCE_ATTRS, NCE_OUTS, (), seed=s)[1][2]
            [:, 2:] for s in (3, 3, 4)]
    negs = runs[0]
    c = NCE["c"]
    assert negs.min() >= 0 and negs.max() < c
    assert abs(negs.mean() - (c - 1) / 2) < 0.03 * (c - 1) / 2
    assert abs(negs.var() - (c * c - 1) / 12) < 0.03 * (c * c - 1) / 12
    assert len(np.unique(negs)) == c
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_nce_reads_nothing_on_the_host(host_read_guard):
    one_op(pt, "nce", _nce_inputs(), NCE_ATTRS, NCE_OUTS,
           ("Input", "Weight", "Bias"))
    assert not host_read_guard, host_read_guard


# ---------------------------------------------------------------------------
# the layers and DetectionMAP
# ---------------------------------------------------------------------------

def loss_layers(pkg):
    L = pkg.layers
    x = L.data("x", shape=[5], dtype="float32")
    y = L.data("y", shape=[4], dtype="float32")
    lbl = L.data("lbl", shape=[1], dtype="int64")
    x.stop_gradient = False
    hs = L.hsigmoid(x, lbl, num_classes=9)
    btp = L.bilinear_tensor_product(x, y, size=3, act="tanh")
    pred = L.data("pred", shape=[6], dtype="int32")
    gt = L.data("gt", shape=[6], dtype="int32")
    miou, wrong, correct = L.mean_iou(pred, gt, num_classes=4)
    loss = L.mean(hs) + L.mean(btp)
    (gx,) = pkg.backward.calc_gradient(loss, [x])
    return [hs, btp, miou, wrong, correct, gx]


def test_loss_layers_build_and_follow_jax():
    rng = np.random.RandomState(2)
    feed = {"x": rand(rng, 6, 5), "y": rand(rng, 6, 4),
            "lbl": rng.randint(0, 9, (6, 1)).astype("int64"),
            "pred": rng.randint(0, 4, (6, 6)).astype("int32"),
            "gt": rng.randint(0, 4, (6, 6)).astype("int32")}
    _, progs, _ = run_both(loss_layers, [feed], fwd=5)
    assert progs[pt][0].to_dict() == progs[fluid][0].to_dict()
    assert progs[pt][1].to_dict() == progs[fluid][1].to_dict()


def test_nce_layer_builds_the_jax_program_and_trains():
    """``layers.nce`` (with and without bias and sample weight) builds the
    JAX builder's main and startup programs, the optimizer's ops
    included, and 25 SGD steps of the port bring its cost under 0.8 of
    the first (``tests/test_sampled_loss_ops.py``'s scenario)."""
    def build(pkg, bias):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 1
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[8])
            label = pkg.layers.data("label", shape=[1], dtype="int64")
            sw = pkg.layers.data("sw", shape=[1])
            cost = pkg.layers.nce(x, label, num_total_classes=20,
                                  num_neg_samples=5, bias_attr=bias,
                                  sample_weight=None if bias else sw)
            avg = pkg.layers.mean(cost)
            pkg.optimizer.SGD(learning_rate=0.5).minimize(avg)
        return main, startup, avg

    for bias in (None, False):
        progs = {pkg: build(pkg, bias) for pkg in (fluid, pt)}
        for i in (0, 1):
            assert progs[pt][i].to_dict() == progs[fluid][i].to_dict()
    main, startup, avg = build(pt, None)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(16, 8).astype("float32"),
            "label": rng.randint(0, 20, (16, 1)).astype("int64"),
            "sw": rng.rand(16, 1).astype("float32") + 0.5}
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[avg],
                            scope=scope)[0][0]) for _ in range(25)]
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0]


def test_detection_map_evaluator_follows_jax():
    """``evaluator.DetectionMAP`` over detections and ground truth fed as
    padded batches: the programs are equal, each batch's mAP equals the
    JAX package's, and ``eval`` averages them alike; ``reset`` clears."""
    rng = np.random.RandomState(6)
    batches = [_detections(rng, 3, 12, 4, 5) for _ in range(3)]
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            det = pkg.layers.data("det", shape=[12, 6], dtype="float32")
            lbl = pkg.layers.data("lbl", shape=[4, 1], dtype="float32")
            box = pkg.layers.data("box", shape=[4, 4], dtype="float32")
            diff = pkg.layers.data("diff", shape=[4, 1], dtype="float32")
            ev = pkg.evaluator.DetectionMAP(det, lbl, box, diff,
                                            class_num=5,
                                            ap_version="11point")
            cur, _ = ev.get_map_var()
        exe = pkg.Executor(pkg.CPUPlace())
        maps = []
        for d, g, _, _ in batches:
            (m,) = exe.run(main, feed={"det": d, "lbl": g[..., :1],
                                       "box": g[..., 1:5],
                                       "diff": g[..., 5:]},
                           fetch_list=[cur])
            ev.update(m)
            maps.append(float(np.asarray(m)[0]))
        res[pkg] = (main.to_dict(), maps, float(ev.eval()[0]))
        ev.reset()
        assert float(ev.eval()[0]) == 0.0
    assert res[pt][0] == res[fluid][0]
    np.testing.assert_allclose(res[pt][1], res[fluid][1], rtol=1e-5)
    np.testing.assert_allclose(res[pt][2], res[fluid][2], rtol=1e-5)
