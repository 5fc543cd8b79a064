"""The control-flow layers and ops held against the JAX package on the
CPU: ``While`` (unbounded, and bounded with its ``while_grad``),
``ConditionalBlock``, ``Switch``, ``IfElse`` (``split_lod_tensor`` /
``merge_lod_tensor``), the tensor arrays, ``beam_search`` and
``beam_search_decode``, on the programs of ``tests/test_control_flow.py``.

Each program is built by the same layer calls in both packages, and the
two serialize alike (``to_dict``, main and startup); the port runs from
the JAX startup state.  Float outputs agree within rtol 1e-5, integer
outputs and beam ids exactly, gradients through a loop within rtol 1e-4.
``beam_search`` breaks a planted tie as ``lax.top_k`` does (equal scores
in order of their flat index), finished beams' -1e9 absorbed to exact
ties included.  The executor's segment plan splits an entry at each
unbounded ``while`` of the global block and runs the same segments
eagerly, and refuses, under capture, an unbounded ``while`` nested in a
sub-block.  No new op reads a value on the host (``host_read_guard``)."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as pt_executor
from paddle_tpu_torch.ops import control_flow
from paddle_tpu_torch.ops.cuda import flash_attention as fa

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_rnn import (FWD, GRAD, build_both, rand, run_both,
                            started_scopes)
from test_torch_serving import fresh_torch_programs  # noqa: F401


def _fetch_both(progs, scopes, feeds):
    """Each package's fetches of its program over ``feeds``."""
    outs = {}
    for pkg in (fluid, pt):
        exe = pkg.Executor(pkg.CPUPlace())
        main, _, fetch = progs[pkg]
        outs[pkg] = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=fetch, scope=scopes[pkg])]
            for f in feeds]
    return outs[fluid], outs[pt]


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

def while_sum(pkg, t_len=4, d=3):
    """The rows of x written into an array, then summed by an unbounded
    While that reads the array at its counter."""
    L = pkg.layers
    x = L.data("x", shape=[t_len, d], dtype="float32",
               append_batch_size=False)
    arr = L.create_array("float32", capacity=t_len, element_shape=[d])
    n = L.fill_constant(shape=[1], dtype="int64", value=t_len)
    acc = L.fill_constant(shape=[d], dtype="float32", value=0.0)
    for t in range(t_len):
        it = L.fill_constant(shape=[1], dtype="int64", value=t)
        row = L.reshape(L.slice(x, axes=[0], starts=[t], ends=[t + 1]),
                        shape=[d])
        arr = L.array_write(row, it, array=arr)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        row = L.array_read(arr, i)
        L.assign(L.elementwise_add(acc, row), output=acc)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond)
    return [acc, i, L.array_length(arr)]


def test_while_sums_array():
    rng = np.random.RandomState(4)
    xv = rng.rand(4, 3).astype("float32")
    (got,), _, _ = run_both(while_sum, [{"x": xv}])
    np.testing.assert_allclose(got[0], xv.sum(0), rtol=1e-5)
    assert got[1].tolist() == [4] and got[2].tolist() == [4]


def test_while_requires_cond_update():
    L = pt.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=3)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with pytest.raises(ValueError, match="condition"):
        with w.block():
            L.increment(i, value=1)


def while_counts(pkg, bound=None, nested=False):
    """fill -> While(i < n: y = 0.5 * y + x) -> scale: ops before and
    after the loop; ``nested`` puts an unbounded While counting j < 2
    inside the body."""
    L = pkg.layers
    x = L.data("x", shape=[3])
    n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
    y = L.scale(x, scale=2.0)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    cond = L.less_than(i, n)
    w = L.While(cond, max_trip_count=bound)
    with w.block():
        L.assign(L.elementwise_add(L.scale(y, scale=0.5), x), output=y)
        if nested:
            j = L.fill_constant(shape=[1], dtype="int64", value=0)
            two = L.fill_constant(shape=[1], dtype="int64", value=2)
            c2 = L.less_than(j, two)
            inner = L.While(c2)
            with inner.block():
                L.assign(L.scale(y, scale=1.5), output=y)
                L.increment(j, value=1)
                L.less_than(j, two, cond=c2)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond)
    return [L.scale(y, scale=3.0), i]


@pytest.mark.parametrize("trips", [0, 1, 5])
def test_unbounded_while_runs_its_segment(trips):
    """The loop splits the entry into ops / loop / ops; the eager path runs
    those segments: max(trips, 1) predicated trips (the first one a no-op
    when the condition starts false), one host read each."""
    rng = np.random.RandomState(trips)
    feed = {"x": rand(rng, 2, 3), "n": np.asarray([trips], "int64")}
    (got,), progs, _ = run_both(while_counts, [feed])
    main = progs[pt][0]
    block = main.global_block()
    plan = pt_executor.segment_plan(block, [True] * len(block.ops))
    kinds = [k for k, _ in plan]
    assert kinds == ["ops", "loop", "ops"]
    assert block.ops[plan[1][1]].type == "while"
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(progs[pt][1], scope=scope)
    exe.run(main, feed=feed, fetch_list=progs[pt][2], scope=scope)
    assert exe.loop_trips == [(plan[1][1], max(trips, 1))]
    assert exe.flag_reads == max(trips, 1)
    assert got[1].tolist() == [trips]


def test_bounded_while_is_not_split():
    """A bounded loop is one op of its segment: no host loop."""
    progs = build_both(lambda pkg: while_counts(pkg, bound=8))
    block = progs[pt][0].global_block()
    plan = pt_executor.segment_plan(block, [True] * len(block.ops),
                                    capture=True)
    assert [k for k, _ in plan] == ["ops"]
    rng = np.random.RandomState(0)
    run_both(lambda pkg: while_counts(pkg, bound=8),
             [{"x": rand(rng, 2, 3), "n": np.asarray([k], "int64")}
              for k in (0, 3, 8, 11)])


def test_nested_unbounded_while_raises_under_capture():
    """An unbounded While inside another While's body: the plan under
    capture refuses it, naming the op and its block; eagerly (the CPU, or
    ``capture=False``) it runs and matches the JAX package."""
    progs = build_both(lambda pkg: while_counts(pkg, nested=True))
    block = progs[pt][0].global_block()
    live = [True] * len(block.ops)
    with pytest.raises(RuntimeError, match=r"op 9 \(while\) of block 1, "
                       r"inside op 6 \(while\) of block 0"):
        pt_executor.segment_plan(block, live, capture=True)
    assert [k for k, _ in pt_executor.segment_plan(block, live)] \
        == ["ops", "loop", "ops"]
    rng = np.random.RandomState(2)
    run_both(lambda pkg: while_counts(pkg, nested=True),
             [{"x": rand(rng, 2, 3), "n": np.asarray([3], "int64")}])


def test_while_backward_trains_through_loop():
    """y <- tanh(fc(y)) for 3 trips of a loop bounded at 8, SGD on the fc
    weight: the loss and the weight's gradient follow the JAX package's
    ``while_grad`` (rtol 1e-5 / 1e-4), and so does the weight after the
    step."""
    d, trips = 3, 3

    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[d])
        y = L.assign(x)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=trips)
        cond = L.less_than(i, n)
        w = L.While(cond, max_trip_count=8)
        with w.block():
            L.assign(L.fc(y, size=d, bias_attr=False, act="tanh",
                          param_attr=pkg.ParamAttr(name="while_w")),
                     output=y)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond)
        loss = L.reduce_mean(L.square(y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, "while_w@GRAD"]

    progs = build_both(build)
    types = [op.type for op in progs[pt][0].global_block().ops]
    assert "while_grad" in types
    scopes = started_scopes(progs)
    feed = {"x": np.random.RandomState(0).rand(4, d).astype("float32")}
    want, got = _fetch_both(progs, scopes, [feed])
    np.testing.assert_allclose(got[0][0], want[0][0], **FWD)
    np.testing.assert_allclose(got[0][1], want[0][1], **GRAD)
    np.testing.assert_allclose(np.asarray(scopes[pt].find_var("while_w")),
                               np.asarray(scopes[fluid].find_var("while_w")),
                               **GRAD)


def test_while_backward_without_bound_raises():
    L = pt.layers
    x = L.data("x", shape=[2])
    y = L.assign(x)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=2)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        L.assign(L.scale(y, scale=0.5), output=y)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond)
    loss = L.reduce_mean(y)
    with pytest.raises(RuntimeError, match="max_trip_count"):
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)


def test_while_upstream_producer_gradient_not_double_counted():
    """The loop carry's upstream producer receives only the through-loop
    gradient (Out aliases LoopVars)."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[6])
        x.stop_gradient = False
        y = L.scale(x, scale=1.0)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=3)
        cond = L.less_than(i, n)
        w = L.While(cond, max_trip_count=8)
        with w.block():
            L.assign(L.scale(y, scale=0.5), output=y)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond)
        (gx,) = pkg.backward.calc_gradient(L.reduce_mean(y), x)
        return [gx]

    (got,), _, _ = run_both(build, [{"x": np.ones((1, 6), "float32")}],
                            fwd=0)
    np.testing.assert_allclose(got[0], np.full((1, 6), 0.5 ** 3 / 6),
                               rtol=1e-6)


def test_while_backward_coupled_carry_unread_var():
    """b += a each trip and the loss reads only b: a's cotangent exists
    only through the carry; d loss / dx = 1 + trips."""
    d, trips = 3, 3

    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[d])
        x.stop_gradient = False
        a, b = L.assign(x), L.assign(x)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=trips)
        cond = L.less_than(i, n)
        w = L.While(cond, max_trip_count=4)
        with w.block():
            L.assign(L.elementwise_add(b, a), output=b)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond)
        (gx,) = pkg.backward.calc_gradient(L.reduce_sum(b), [x])
        return [gx]

    (got,), _, _ = run_both(build, [{"x": np.ones((2, d), "float32")}],
                            fwd=0)
    np.testing.assert_allclose(got[0], np.full((2, d), 1.0 + trips),
                               rtol=1e-5)


def test_body_attention_dropout_repeats_its_mask_every_trip(monkeypatch):
    """A random op in a While body draws the same seed every trip, as the
    JAX body, traced once, draws one key: ``fused_attention`` with
    dropout 0.5 over the same inputs in each of 3 trips of a bounded loop
    writes the same output every trip, in both packages, from one device
    seed in the port."""
    b, h, t, dh, trips = 2, 2, 8, 16, 3
    seeds = []
    real = fa.flash_attention

    def spy(q, k, v, k_len, seed, *args):
        seeds.append(seed.clone())
        return real(q, k, v, k_len, seed, *args)

    monkeypatch.setattr(fa, "flash_attention", spy)

    def build(pkg):
        L = pkg.layers
        q, k, v = (L.data(nm, shape=[h, t, dh]) for nm in "qkv")
        arr = L.create_array("float32", capacity=trips,
                             element_shape=[b, h, t, dh])
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=trips)
        cond = L.less_than(i, n)
        w = L.While(cond, max_trip_count=trips)
        with w.block():
            out = L.fused_attention(q, k, v, dropout_rate=0.5)
            L.assign(L.array_write(out, i, array=arr), output=arr)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond)
        return [arr]

    progs = build_both(build)
    scopes = started_scopes(progs)
    rng = np.random.RandomState(5)
    feed = {nm: rand(rng, b, h, t, dh) for nm in "qkv"}
    want, got = _fetch_both(progs, scopes, [feed])
    for arr in (want[0][0], got[0][0]):
        assert all(np.array_equal(arr[0], arr[j]) for j in range(trips))
    assert len(seeds) == trips
    assert all(np.array_equal(s.numpy(), seeds[0].numpy()) for s in seeds)
    # the trip's output is the hash-masked attention at that one seed, and
    # a dropout of 0.5 is not the identity
    qkv = [torch.from_numpy(feed[nm]) for nm in "qkv"]
    np.testing.assert_array_equal(
        got[0][0][0], real(*qkv, None, seeds[0], False, 0.5, None).numpy())
    assert not np.allclose(got[0][0][0], real(*qkv, None, None, False, 0.0,
                                              None).numpy())


# ---------------------------------------------------------------------------
# IfElse / ConditionalBlock / Switch
# ---------------------------------------------------------------------------

def ifelse(pkg, b=6, d=3):
    L = pkg.layers
    x = L.data("x", shape=[d])
    x.stop_gradient = False
    limit = L.fill_constant(shape=[1], dtype="float32", value=1.5)
    cond = L.less_than(L.reduce_sum(x, dim=1, keep_dim=True), limit)
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), scale=-1.0))
    out = ie()
    (gx,) = pkg.backward.calc_gradient(L.reduce_sum(L.square(out)), [x])
    return [out, gx]


def test_ifelse_rows_and_gradient():
    rng = np.random.RandomState(6)
    xv = rng.rand(6, 3).astype("float32")
    (got,), _, _ = run_both(ifelse, [{"x": xv}], fwd=1)
    mask = xv.sum(1, keepdims=True) < 1.5
    np.testing.assert_allclose(got[0], np.where(mask, 2 * xv, -xv),
                               rtol=1e-5)


def cond_block(pkg):
    """out = fc(x) * 10 only when x[0] < 0.5 (else 0.5 x - 1), and the
    gradients of sum(out * x) reaching x and the fc's weight."""
    L = pkg.layers
    x = L.data("x", shape=[1, 4], dtype="float32", append_batch_size=False)
    x.stop_gradient = False
    thresh = L.fill_constant(shape=[1], dtype="float32", value=0.5)
    out = L.scale(x, scale=0.5, bias=-1.0)
    cond = L.less_than(L.reshape(L.slice(x, axes=[1], starts=[0], ends=[1]),
                                 shape=[1]), thresh)
    cb = L.ConditionalBlock([cond])
    with cb.block():
        L.assign(L.scale(L.fc(x, size=4, param_attr=pkg.ParamAttr(
            name="cb_w"), bias_attr=False), scale=10.0), output=out)
    loss = L.reduce_sum(L.elementwise_mul(out, x))
    pkg.backward.append_backward(loss)
    return [out, "x@GRAD", "cb_w@GRAD"]


@pytest.mark.parametrize("first", [0.2, 0.9], ids=["taken", "not_taken"])
def test_conditional_block_and_its_gradient(first):
    """Predicated where JAX runs one branch: the same values, and the
    gradient of a branch not taken is zero for its weight and the
    identity's for x."""
    xv = np.asarray([[first, 0.3, -0.4, 0.7]], "float32")
    (got,), _, _ = run_both(cond_block, [{"x": xv}], fwd=1)
    if first > 0.5:
        np.testing.assert_allclose(got[0], 0.5 * xv - 1.0, rtol=1e-6)
        np.testing.assert_allclose(got[1], 2 * 0.5 * xv - 1.0, rtol=1e-6)
        assert not got[2].any()
    else:
        assert got[2].any()


def switch(pkg):
    L = pkg.layers
    step = L.data("step", shape=[1], dtype="float32",
                  append_batch_size=False)
    lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    b1 = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    b2 = L.fill_constant(shape=[1], dtype="float32", value=20.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 1.0), output=lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.5), output=lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.1), output=lr)
    return [lr]


def test_switch_piecewise():
    feeds = [{"step": np.asarray([s], "float32")} for s in (5., 15., 25.)]
    got, _, _ = run_both(switch, feeds)
    assert [float(g[0][0]) for g in got] == pytest.approx([1.0, 0.5, 0.1])


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------

def arrays(pkg):
    """Two writes and two reads, an index past the capacity (clamped),
    the length, and the gradient of the reads' sum."""
    L = pkg.layers
    x = L.data("x", shape=[4])
    x.stop_gradient = False
    i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
    i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
    i9 = L.fill_constant(shape=[1], dtype="int64", value=9)
    arr = L.array_write(L.scale(x, scale=3.0), i0, capacity=2)
    arr = L.array_write(L.scale(x, scale=5.0), i1, array=arr)
    y0, y1, y9 = (L.array_read(arr, i) for i in (i0, i1, i9))
    loss = L.reduce_sum(L.elementwise_add(y0, y1))
    (gx,) = pkg.backward.calc_gradient(loss, [x])
    return [arr, y9, L.array_length(arr), gx]


def test_tensor_array_write_read_backward():
    (got,), _, _ = run_both(arrays, [{"x": np.ones((2, 4), "float32")}],
                            fwd=3)
    np.testing.assert_allclose(got[3], np.full((2, 4), 8.0), rtol=1e-5)
    np.testing.assert_allclose(got[1], np.full((2, 4), 5.0))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _np_beam_step(pre_ids, pre_scores, scores, end_id):
    """The step as lax.top_k takes it: candidates by score, equal scores
    in order of their flat index (k * V + v), finished beams' others at
    -1e9 + pre_score in float32."""
    b, k, v = scores.shape
    step = np.where((pre_ids == end_id)[:, :, None], np.float32(-1e9),
                    scores)
    step[:, :, end_id] = np.where(pre_ids == end_id, np.float32(0),
                                  scores[:, :, end_id])
    flat = (pre_scores[:, :, None] + step).astype("float32").reshape(b, -1)
    order = np.argsort(-flat, axis=1, kind="stable")[:, :k]
    return (order % v).astype("int64"), np.take_along_axis(flat, order, 1), \
        (order // v).astype("int64")


def beam_step(pkg, b, k, v):
    L = pkg.layers
    p_ids = L.data("pre_ids", shape=[b, k], dtype="int64",
                   append_batch_size=False)
    p_sc = L.data("pre_scores", shape=[b, k], dtype="float32",
                  append_batch_size=False)
    sc = L.data("scores", shape=[b, k, v], dtype="float32",
                append_batch_size=False)
    return list(L.beam_search(p_ids, p_sc, sc, beam_size=k, end_id=0))


def _beam_feed(pre_ids, pre_scores, scores):
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}


def test_beam_search_step_oracle():
    b, k, v = 2, 3, 7
    rng = np.random.RandomState(8)
    pre_ids = np.array([[3, 0, 2], [1, 4, 0]], "int64")
    pre_scores = rng.rand(b, k).astype("float32") * -1.0
    scores = np.log(rng.dirichlet(np.ones(v), size=(b, k))
                    .astype("float32") + 1e-9).astype("float32")
    feed = _beam_feed(pre_ids, pre_scores, scores)
    (got,), _, _ = run_both(lambda pkg: beam_step(pkg, b, k, v), [feed])
    ids, sc, par = _np_beam_step(pre_ids, pre_scores, scores, 0)
    np.testing.assert_array_equal(got[0], ids)
    np.testing.assert_array_equal(got[2], par)
    np.testing.assert_allclose(got[1], sc, rtol=1e-6)


def test_beam_search_breaks_a_planted_tie_as_top_k():
    """Row 0: two finished beams tie at -0.5 (flat 0 and 6), and beams 2
    and 3 carry equal scores with a tie inside each; row 1: every score
    absorbed into -1e9 by the lane penalty, so all 24 candidates tie.
    The port picks what ``lax.top_k`` picks, id and parent for each."""
    b, k, v = 2, 4, 6
    pre_ids = np.array([[0, 0, 2, 3], [1, 2, 3, 4]], "int64")
    pre_scores = np.array([[-0.5, -0.5, -50.0, -50.0],
                           [-1e9, -1e9, -1e9, -1e9]], "float32")
    row = np.log(np.array([.1, .3, .3, .1, .1, .1], "float32"))
    scores = np.tile(row, (b, k, 1)).astype("float32")
    feed = _beam_feed(pre_ids, pre_scores, scores)
    (got,), _, _ = run_both(lambda pkg: beam_step(pkg, b, k, v), [feed])
    ids, _, par = _np_beam_step(pre_ids, pre_scores, scores, 0)
    np.testing.assert_array_equal(got[0], ids)
    np.testing.assert_array_equal(got[2], par)
    assert got[0][0].tolist() == [0, 0, 1, 2]
    assert got[2][0].tolist() == [0, 1, 2, 2]
    assert got[0][1].tolist() == [0, 1, 2, 3]
    assert got[2][1].tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("seed", range(4))
def test_top_k_first_index_is_lax_top_k(seed):
    """``beam_search``'s selection against ``lax.top_k`` itself on rows
    full of ties (small integers, and -1e9 absorbing small offsets)."""
    import jax

    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 3, (6, 97)).astype("float32")
    x[1] = -1e9 + rng.randint(0, 3, 97).astype("float32")
    x[2] = rng.randn(97).astype("float32")
    for k in (1, 4, 7):
        want_v, want_i = jax.lax.top_k(x, k)
        got_v, got_i = control_flow.top_k_first_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_beam_search_decode_backtrack():
    def build(pkg):
        L = pkg.layers
        idv = L.data("ids", shape=[3, 1, 2], dtype="int64",
                     append_batch_size=False)
        pav = L.data("parents", shape=[3, 1, 2], dtype="int64",
                     append_batch_size=False)
        scv = L.data("scores", shape=[1, 2], dtype="float32",
                     append_batch_size=False)
        return list(L.beam_search_decode(idv, pav, scv, beam_size=2,
                                         end_id=0))

    feed = {"ids": np.array([[[5, 6]], [[7, 8]], [[9, 10]]], "int64"),
            "parents": np.array([[[0, 0]], [[0, 0]], [[1, 0]]], "int64"),
            "scores": np.array([[0.9, 0.4]], "float32")}
    (got,), _, _ = run_both(build, [feed])
    np.testing.assert_array_equal(got[0][0], [[5, 8, 9], [5, 7, 10]])


# ---------------------------------------------------------------------------
# no host reads
# ---------------------------------------------------------------------------

PROGRAMS = {
    "while_sum": (while_sum, lambda rng: {"x": rand(rng, 4, 3)}),
    "ifelse": (ifelse, lambda rng: {"x": rand(rng, 6, 3)}),
    "cond_block": (cond_block, lambda rng: {"x": rand(rng, 1, 4)}),
    "switch": (switch, lambda rng: {"step": np.asarray([15.], "float32")}),
    "arrays": (arrays, lambda rng: {"x": rand(rng, 2, 4)}),
    "beam_step": (lambda pkg: beam_step(pkg, 2, 3, 7), lambda rng:
                  _beam_feed(np.array([[3, 0, 2], [1, 4, 0]], "int64"),
                             rand(rng, 2, 3), rand(rng, 2, 3, 7))),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_read_nothing_on_the_host(host_read_guard, name):
    """Every op of these programs, forward and grad, and the body ops of
    their loops: no value read on the host (the executor's own read of an
    unbounded loop's condition is not an op's)."""
    build, feed = PROGRAMS[name]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        fetch = build(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed(np.random.RandomState(0)), fetch_list=fetch,
            scope=scope)
    assert host_read_guard == []


def test_bounded_while_grad_reads_nothing_on_the_host(host_read_guard):
    rng = np.random.RandomState(0)

    def build(pkg):
        out, _ = while_counts(pkg, bound=4)
        x = pkg.default_main_program().global_block().var("x")
        x.stop_gradient = False
        (gx,) = pkg.backward.calc_gradient(pkg.layers.reduce_sum(out), [x])
        return [out, gx]

    _, progs, _ = run_both(build, [{"x": rand(rng, 2, 3),
                                    "n": np.asarray([3], "int64")}], fwd=1)
    assert host_read_guard == []
    assert "while_grad" in [op.type for op in
                            progs[pt][0].global_block().ops]
