"""Sub-blocks, the ``recurrent`` op, the LSTM/GRU family and the loss's
soft labels and ``ignore_index`` in the port, held against the JAX
package on the CPU.

Every case builds one program in both packages (``to_dict()`` equal,
block 1 included), starts the port from the JAX startup state and feeds
both the same seeded numpy inputs.  Tolerances: forward values rtol 1e-5
(atol 1e-6), gradients rtol 1e-4 (atol 1e-6); trajectories rtol 1e-4.
The StaticRNN / DynamicRNN cases are ``tests/test_control_flow.py``'s,
each also run through the JAX package."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.framework import grad_var_name

from test_torch_serving import fresh_torch_programs  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def build_both(build, seed=3):
    """``build(pkg)`` -> fetch list, in each package under fresh programs
    of one seed; asserts equal ``to_dict()`` (main and startup).  Returns
    {pkg: (main, startup, fetch)}."""
    out = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup), pkg.unique_name.guard("t_"):
            fetch = build(pkg)
        out[pkg] = (main, startup, fetch)
    assert out[pt][0].to_dict() == out[fluid][0].to_dict()
    assert out[pt][1].to_dict() == out[fluid][1].to_dict()
    return out


def started_scopes(progs):
    """The JAX startup run, and the port's scope loaded from its state."""
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(progs[fluid][1], scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in progs[fluid][1].list_vars() if v.persistable}
    tscope = pt.Scope()
    load_numpy_state(tscope, progs[pt][1], state, "cpu")
    return {fluid: jscope, pt: tscope}


def run_both(build, feeds, fwd=None, seed=3):
    """Run ``build``'s program in both packages over ``feeds`` (one run
    each); the first ``fwd`` fetches (all when None) held at ``FWD``, the
    rest at ``GRAD``.  Returns (the port's fetches of every run, the
    programs ``build_both`` made, the scopes after the runs)."""
    progs = build_both(build, seed)
    scopes = started_scopes(progs)
    outs = {}
    for pkg in (fluid, pt):
        exe = pkg.Executor(pkg.CPUPlace())
        main, _, fetch = progs[pkg]
        outs[pkg] = [exe.run(main, feed=f, fetch_list=fetch,
                             scope=scopes[pkg]) for f in feeds]
    for want_run, got_run in zip(outs[fluid], outs[pt]):
        n = len(got_run) if fwd is None else fwd
        for i, (w, g) in enumerate(zip(want_run, got_run)):
            np.testing.assert_allclose(g, np.asarray(w),
                                       **(FWD if i < n else GRAD))
    return outs[pt], progs, scopes


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


# ---------------------------------------------------------------------------
# framework: sub-blocks
# ---------------------------------------------------------------------------

def test_create_block_and_rollback():
    """``_create_block`` appends a child of the current block and makes it
    current; ``_rollback`` returns to the parent; vars resolve through
    the parent chain."""
    for pkg in (fluid, pt):
        prog = pkg.Program()
        g = prog.global_block()
        g.create_var(name="outer", shape=(2,), dtype="float32")
        b1 = prog._create_block()
        assert (b1.idx, b1.parent_idx, prog.current_block()) == (1, 0, b1)
        b2 = prog._create_block()
        assert b2.parent_block is b1 and prog.current_block_idx == 2
        assert b2.has_var_recursive("outer") and not b2.has_var("outer")
        prog._rollback()
        prog._rollback()
        assert prog.current_block() is g
        assert prog.to_dict()["blocks"][2]["parent_idx"] == 1


def static_rnn_program(pkg, t_len=5, b=3, d=4, with_fc=False):
    x = pkg.layers.data("x", shape=[t_len, b, d], dtype="float32",
                        append_batch_size=False)
    h0 = pkg.layers.data("h0", shape=[b, d], dtype="float32",
                         append_batch_size=False)
    rnn = pkg.layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_pre = rnn.memory(init=h0)
        if with_fc:
            h = pkg.layers.fc(pkg.layers.concat([x_t, h_pre], axis=1),
                              size=d, act="tanh")
        else:
            h = pkg.layers.elementwise_add(
                pkg.layers.scale(h_pre, scale=0.5), x_t)
        rnn.update_memory(h_pre, h)
        rnn.step_output(h)
    return rnn()


def test_two_block_program_round_trips():
    """A StaticRNN program serializes as the JAX package's, block 1
    included; ``from_dict``, JSON and ``clone`` keep both blocks, and the
    copy computes the same."""
    progs = build_both(lambda pkg: [static_rnn_program(pkg, with_fc=True)])
    main = progs[pt][0]
    d = main.to_dict()
    assert len(d["blocks"]) == 2 and d["blocks"][1]["parent_idx"] == 0
    assert [op["type"] for op in d["blocks"][0]["ops"]] == ["recurrent"]
    assert pt.Program.from_json(main.to_json()).to_dict() == d
    assert main.clone().to_dict() == d
    scopes = started_scopes(progs)
    rng = np.random.RandomState(0)
    feed = {"x": rand(rng, 5, 3, 4), "h0": rand(rng, 3, 4)}
    exe = pt.Executor(pt.CPUPlace())
    fetch = progs[pt][2]
    a = exe.run(main, feed=feed, fetch_list=fetch, scope=scopes[pt])
    b = exe.run(pt.Program.from_dict(d), feed=feed,
                fetch_list=[v.name for v in fetch], scope=scopes[pt])
    np.testing.assert_array_equal(a[0], b[0])


# ---------------------------------------------------------------------------
# tests/test_control_flow.py's StaticRNN / DynamicRNN cases
# ---------------------------------------------------------------------------

def test_static_rnn_accumulator_oracle():
    rng = np.random.RandomState(0)
    xv, h0v = rand(rng, 5, 3, 4), rand(rng, 3, 4)
    ((ov,),), _, _ = run_both(lambda pkg: [static_rnn_program(pkg)],
                              [{"x": xv, "h0": h0v}])
    ref, h = np.zeros_like(xv), h0v.copy()
    for t in range(5):
        h = 0.5 * h + xv[t]
        ref[t] = h
    np.testing.assert_allclose(ov, ref, rtol=1e-5)


def test_static_rnn_grad_numeric():
    """The gradient through the loop against central differences (and
    against the JAX package's)."""
    t_len, b, d = 4, 2, 3

    def build(pkg):
        x = pkg.layers.data("x", shape=[t_len, b, d], dtype="float32",
                            append_batch_size=False, stop_gradient=False)
        h0 = pkg.layers.data("h0", shape=[b, d], dtype="float32",
                             append_batch_size=False)
        rnn = pkg.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_pre = rnn.memory(init=h0)
            h = pkg.layers.tanh(pkg.layers.elementwise_add(
                pkg.layers.scale(h_pre, scale=0.7), x_t))
            rnn.update_memory(h_pre, h)
            rnn.step_output(h)
        loss = pkg.layers.reduce_sum(rnn())
        pkg.append_backward(loss) if pkg is fluid else \
            pt.backward.append_backward(loss)
        return [loss, grad_var_name("x")]

    rng = np.random.RandomState(1)
    xv = rng.rand(t_len, b, d).astype("float32") * 0.5
    h0v = rng.rand(b, d).astype("float32") * 0.5
    ((_, gx),), progs, _ = run_both(build, [{"x": xv, "h0": h0v}], fwd=1)
    main, _, (loss, _) = progs[pt]
    exe = pt.Executor(pt.CPUPlace())
    eps, num = 1e-3, np.zeros_like(xv)
    for idx in np.ndindex(*xv.shape):
        for sgn in (1, -1):
            xp = xv.copy()
            xp[idx] += sgn * eps
            (l2,) = exe.run(main, feed={"x": xp, "h0": h0v},
                            fetch_list=[loss])
            num[idx] += sgn * float(np.asarray(l2).ravel()[0])
    num /= 2 * eps
    np.testing.assert_allclose(gx, num, rtol=5e-2, atol=5e-3)


def control_flow_train(build, feeds, steps):
    """``build(pkg)`` -> loss under Adam in both packages from one startup
    state; ``steps`` runs over ``feeds(i)``: the two loss trajectories
    (rtol 1e-4).  Returns the port's losses."""
    progs = build_both(lambda pkg: [build(pkg)], seed=11)
    scopes = started_scopes(progs)
    losses = {}
    for pkg in (fluid, pt):
        main, _, fetch = progs[pkg]
        exe = pkg.Executor(pkg.CPUPlace())
        losses[pkg] = [float(np.asarray(exe.run(
            main, feed=feeds(i), fetch_list=fetch,
            scope=scopes[pkg])[0]).ravel()[0]) for i in range(steps)]
    np.testing.assert_allclose(losses[pt], losses[fluid], rtol=1e-4)
    return losses[pt]


def test_static_rnn_with_params_trains():
    """fc inside the step block: weight gradients flow through the loop."""
    t_len, b, d, h_dim = 6, 4, 5, 5

    def build(pkg):
        x = pkg.layers.data("x", shape=[t_len, b, d], dtype="float32",
                            append_batch_size=False)
        label = pkg.layers.data("label", shape=[b, 1], dtype="int64",
                                append_batch_size=False)
        h0 = pkg.layers.fill_constant(shape=[b, h_dim], dtype="float32",
                                      value=0.0)
        rnn = pkg.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_pre = rnn.memory(init=h0)
            h = pkg.layers.fc(pkg.layers.concat([x_t, h_pre], axis=1),
                              size=h_dim, act="tanh")
            rnn.update_memory(h_pre, h)
            rnn.step_output(h)
        last = pkg.layers.slice(rnn(), axes=[0], starts=[t_len - 1],
                                ends=[t_len])
        last = pkg.layers.reshape(last, shape=[b, h_dim])
        pred = pkg.layers.fc(last, size=3, act=None)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(pred, label))
        pkg.optimizer.Adam(learning_rate=5e-2).minimize(loss)
        return loss

    rng = np.random.RandomState(2)
    feed = {"x": rng.rand(t_len, b, d).astype("float32"),
            "label": rng.randint(0, 3, (b, 1)).astype("int64")}
    losses = control_flow_train(build, lambda i: feed, 30)
    assert losses[-1] < losses[0] * 0.5, losses


def test_static_rnn_mixed_dtype_inputs_keep_grads():
    """An int64 step input (token ids) rides ``IntInputs`` and leaves the
    float step input differentiable."""
    t_len, b, d, v = 3, 2, 4, 6

    def build(pkg):
        x = pkg.layers.data("x", shape=[t_len, b, d], dtype="float32",
                            append_batch_size=False, stop_gradient=False)
        ids = pkg.layers.data("ids", shape=[t_len, b, 1], dtype="int64",
                              append_batch_size=False)
        rnn = pkg.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            id_t = rnn.step_input(ids)
            emb = pkg.layers.embedding(id_t, size=[v, d])
            h_pre = rnn.memory(shape=[d], batch_ref=x_t, init_value=0.0)
            h = pkg.layers.tanh(pkg.layers.elementwise_add(
                pkg.layers.elementwise_add(h_pre, x_t), emb))
            rnn.update_memory(h_pre, h)
            rnn.step_output(h)
        loss = pkg.layers.reduce_sum(rnn())
        pkg.append_backward(loss) if pkg is fluid else \
            pt.backward.append_backward(loss)
        return [loss, grad_var_name("x")]

    rng = np.random.RandomState(12)
    feed = {"x": rng.rand(t_len, b, d).astype("float32") * 0.1,
            "ids": rng.randint(0, v, (t_len, b, 1)).astype("int64")}
    ((_, gx),), progs, _ = run_both(build, [feed], fwd=1)
    op = next(o for o in progs[pt][0].global_block().ops
              if o.type == "recurrent")
    assert op.inputs["Inputs"] == ["x"] and op.inputs["IntInputs"] == ["ids"]
    assert np.isfinite(gx).all() and np.abs(gx).sum() > 0


def dynamic_rnn_sum(pkg, d, h_dim=None):
    x = pkg.layers.data("x", shape=[d], dtype="float32", lod_level=1)
    drnn = pkg.layers.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        h_pre = drnn.memory(shape=[h_dim or d], value=0.0)
        if h_dim:
            h = pkg.layers.fc(pkg.layers.concat([x_t, h_pre], axis=1),
                              size=h_dim, act="tanh")
        else:
            h = pkg.layers.elementwise_add(h_pre, x_t)
        drnn.update_memory(h_pre, h)
        drnn.output(h)
    return drnn()


def test_dynamic_rnn_masks_padding():
    """A row past its length keeps its memory and emits zeros."""
    b, t_len, d = 3, 5, 2
    rng = np.random.RandomState(3)
    xv = rng.rand(b, t_len, d).astype("float32")
    lens = np.array([5, 2, 3], "int32")
    ((ov,),), _, _ = run_both(lambda pkg: [dynamic_rnn_sum(pkg, d)],
                              [{"x": xv, "x@LEN": lens}])
    ref = np.zeros((b, t_len, d), "float32")
    for bi in range(b):
        ref[bi, :lens[bi]] = np.cumsum(xv[bi, :lens[bi]], axis=0)
    np.testing.assert_allclose(ov, ref, rtol=1e-5)
    assert np.all(ov[1, 2:] == 0) and np.all(ov[2, 3:] == 0)


def test_dynamic_rnn_trains_sequence_sum():
    d, h_dim = 3, 8

    def build(pkg):
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        last = pkg.layers.sequence_pool(dynamic_rnn_sum(pkg, d, h_dim),
                                        "last")
        pred = pkg.layers.fc(last, size=1, act=None)
        loss = pkg.layers.mean(pkg.layers.square(
            pkg.layers.elementwise_sub(pred, y)))
        pkg.optimizer.Adam(learning_rate=2e-2).minimize(loss)
        return loss

    rng = np.random.RandomState(5)
    feeds = []
    for _ in range(40):
        xv = rng.rand(8, 6, d).astype("float32")
        lens = rng.randint(2, 7, (8,)).astype("int32")
        yv = np.array([xv[i, :lens[i]].sum() for i in range(8)],
                      "float32").reshape(-1, 1) / 6.0
        feeds.append({"x": xv, "x@LEN": lens, "y": yv})
    losses = control_flow_train(build, feeds.__getitem__, 40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.5, losses


# ---------------------------------------------------------------------------
# the recurrent op's gradient, randomness and executor analysis
# ---------------------------------------------------------------------------

def test_grads_reach_params_and_stop_at_ints_consts_and_length():
    """The generic ``recurrent_grad`` writes gradients of ``Inputs``,
    ``InitStates`` and ``Params`` (the body's fc weight, an outer float
    activation) and of nothing in ``IntInputs``, ``Consts`` or
    ``Length``."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[3], dtype="float32", lod_level=1,
                            stop_gradient=False)
        ids = pkg.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
        ctx = pkg.layers.data("ctx", shape=[3], dtype="float32",
                              stop_gradient=False)
        scale = pkg.layers.data("k", shape=[1], dtype="int64")
        drnn = pkg.layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            drnn.step_input(ids)
            h_pre = drnn.memory(shape=[3], value=0.0)
            h = pkg.layers.fc(pkg.layers.concat(
                [x_t, h_pre, pkg.layers.elementwise_mul(ctx, ctx)], axis=1),
                size=3, act="tanh")
            pkg.layers.cast(scale, "float32")
            drnn.update_memory(h_pre, h)
            drnn.output(h)
        loss = pkg.layers.mean(drnn())
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]

    progs = build_both(build)
    block = progs[pt][0].global_block()
    fwd = next(op for op in block.ops if op.type == "recurrent")
    grad = next(op for op in block.ops if op.type == "recurrent_grad")
    assert fwd.inputs["IntInputs"] == ["ids"]
    assert fwd.inputs["Consts"] == ["k"] and fwd.inputs["Length"]
    assert set(grad.outputs) == {"GRAD::Inputs", "GRAD::InitStates",
                                 "GRAD::Params"}
    assert "ctx@GRAD" in grad.outputs["GRAD::Params"]
    assert grad.attrs["__fwd_op_index__"] == block.ops.index(fwd)
    exe = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(0)
    feed = {"x": rand(rng, 2, 4, 3), "x@LEN": np.array([4, 2], "int32"),
            "ids": rng.randint(0, 5, (2, 4, 1)).astype("int64"),
            "ids@LEN": np.array([4, 2], "int32"),
            "ctx": rand(rng, 2, 3), "k": np.array([[2], [3]], "int64")}
    scopes = started_scopes(progs)
    got = exe.run(progs[pt][0], feed=feed,
                  fetch_list=["ctx@GRAD", "x@GRAD"], scope=scopes[pt])
    assert all(np.abs(g).sum() > 0 for g in got)
    # x's padded steps get no gradient
    assert np.all(got[1][1, 2:] == 0)


def test_executor_counts_body_reads_as_the_ops():
    """An outer var read only inside the body (``Params``) keeps its
    producer live and is freed after the recurrent op, not before; the
    recurrent op's forward is kept for its grad op (``graph_ops``)."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[2], dtype="float32", lod_level=1)
        proj = pkg.layers.fc(x, size=2, num_flatten_dims=2)
        ctx = pkg.layers.sequence_pool(proj, "sum")
        drnn = pkg.layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            h_pre = drnn.memory(shape=[2], value=0.0)
            h = pkg.layers.elementwise_add(
                pkg.layers.elementwise_add(h_pre, x_t), ctx)
            drnn.update_memory(h_pre, h)
            drnn.output(h)
        loss = pkg.layers.mean(drnn())
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]

    progs = build_both(build)
    main = progs[pt][0]
    block = main.global_block()
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((2, 3, 2), "float32"),
            "x@LEN": np.array([3, 1], "int32")}
    scope = started_scopes(progs)[pt]
    state, _, live, release, graph_ops = exe._analyze(
        main, sorted(feed), scope, [progs[pt][2][0].name])
    rec = next(i for i, op in enumerate(block.ops) if op.type == "recurrent")
    pool = next(i for i, op in enumerate(block.ops)
                if op.type == "sequence_pool")
    ctx = block.ops[pool].outputs["Out"][0]
    assert live[pool] and rec in graph_ops
    freed_at = next(i for i, names in enumerate(release) if ctx in names)
    assert freed_at > rec
    (lv,) = exe.run(main, feed=feed, fetch_list=progs[pt][2], scope=scope)
    assert np.isfinite(lv).all()


def test_body_dropout_gradient_uses_the_forward_masks():
    """Dropout in a StaticRNN body: the gradient of sum(out) with respect
    to x is the forward's keep mask, step by step (a recompute would draw
    new masks), and two runs draw different masks."""
    t_len, b, d = 6, 8, 16
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 9
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[t_len, b, d], dtype="float32",
                           append_batch_size=False, stop_gradient=False)
        rnn = pt.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            rnn.step_output(pt.layers.dropout(x_t, dropout_prob=0.5))
        out = rnn()
        loss = pt.layers.reduce_sum(out)
        pt.backward.append_backward(loss)
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((t_len, b, d), "float32")}
    runs = [exe.run(main, feed=feed, fetch_list=[out, "x@GRAD"])
            for _ in range(2)]
    for ov, gx in runs:
        np.testing.assert_array_equal(gx, (ov != 0).astype("float32"))
        assert 0.3 < gx.mean() < 0.7
    assert not np.array_equal(runs[0][0], runs[1][0])


def test_sub_context_seeds_are_its_own():
    """A body op's seed differs from the outer op of the same index and
    from the same body op at another step; a sub-context's ``saved`` is
    its own; the seeds are a pure function of the run key."""
    g = torch.Generator().manual_seed(4)
    ctx = registry.ComputeContext("cpu", g, 4)
    outer = ctx.seed32(0).item()
    subs = [ctx.sub_context(2, t) for t in range(3)]
    seeds = [s.seed32(0).item() for s in subs]
    assert outer not in seeds and len(set(seeds)) == 3
    subs[0].saved["k"] = 1
    assert "k" not in ctx.saved and "k" not in subs[1].saved
    again = registry.ComputeContext("cpu", torch.Generator().manual_seed(4),
                                    4)
    assert again.sub_context(2, 1).seed32(0).item() == seeds[1]


def test_two_block_inference_model_round_trips(tmp_path):
    """``save_inference_model`` / ``load_inference_model`` over a program
    with a DynamicRNN: the loaded program holds both blocks and computes
    the same bits."""
    out = dynamic_rnn_sum(pt, 3, h_dim=4)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    rng = np.random.RandomState(1)
    feed = {"x": rand(rng, 2, 5, 3), "x@LEN": np.array([5, 3], "int32")}
    (want,) = exe.run(feed=feed, fetch_list=[out])
    pt.io.save_inference_model(str(tmp_path), ["x", "x@LEN"], [out], exe)
    with pt.scope_guard(pt.Scope()):
        prog, feeds, fetch = pt.io.load_inference_model(str(tmp_path), exe)
        assert len(prog.blocks) == 2 and feeds == ["x", "x@LEN"]
        (got,) = exe.run(prog, feed=feed, fetch_list=fetch)
    np.testing.assert_array_equal(got, want)
    with open(tmp_path / "__model__") as f:
        assert json.load(f)["program"]["blocks"][1]["ops"]


# ---------------------------------------------------------------------------
# ops/rnn.py against the JAX package
# ---------------------------------------------------------------------------

B, T, H = 3, 5, 4


def seq_feed(rng, width, ragged):
    lens = np.array([5, 2, 4] if ragged else [T] * B, "int32")
    return {"x": rand(rng, B, T, width), "x@LEN": lens}


def backward(pkg, loss):
    if pkg is fluid:
        fluid.append_backward(loss)
    else:
        pt.backward.append_backward(loss)


def weighted_sum(pkg, outs, names):
    """sum_i <outs[i], g_i>, the g_i fed: a cotangent for every output."""
    parts = []
    for o, n in zip(outs, names):
        g = pkg.layers.data(n, shape=list(o.shape[1:]), dtype="float32")
        parts.append(pkg.layers.reduce_sum(pkg.layers.elementwise_mul(o, g)))
    return pkg.layers.sums(parts)


@pytest.mark.parametrize("peep,reverse,ragged,init", [
    (True, False, True, False), (False, True, True, False),
    (True, True, False, True), (False, False, True, True)])
def test_lstm_op_matches_jax(peep, reverse, ragged, init):
    """``dynamic_lstm`` (gate order c, i, f, o): Hidden and Cell, and the
    gradients of the input, weight, bias (peepholes in its 7H) and of
    H0 / C0."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[4 * H], dtype="float32",
                            lod_level=1, stop_gradient=False)
        h0 = c0 = None
        if init:
            h0, c0 = (pkg.layers.data(n, shape=[H], dtype="float32",
                                      stop_gradient=False)
                      for n in ("h0", "c0"))
        hid, cell = pkg.layers.dynamic_lstm(
            x, size=4 * H, h_0=h0, c_0=c0, use_peepholes=peep,
            is_reverse=reverse)
        backward(pkg, weighted_sum(pkg, [hid, cell], ["gh", "gc"]))
        names = ["x"] + (["h0", "c0"] if init else []) + [
            p.name for p in pkg.default_main_program().all_parameters()]
        return [hid, cell] + [grad_var_name(n) for n in names]

    rng = np.random.RandomState(7)
    feed = seq_feed(rng, 4 * H, ragged)
    feed.update(gh=rand(rng, B, T, H), gc=rand(rng, B, T, H))
    if init:
        feed.update(h0=rand(rng, B, H), c0=rand(rng, B, H))
    ((hid, _, gx, *_),), _, _ = run_both(build, [feed], fwd=2)
    lens = feed["x@LEN"]
    for bi in range(B):
        assert np.all(hid[bi, lens[bi]:] == 0)
        assert np.all(gx[bi, lens[bi]:] == 0)


@pytest.mark.parametrize("peep,reverse", [(True, False), (False, True)])
def test_lstmp_op_matches_jax(peep, reverse):
    def build(pkg):
        x = pkg.layers.data("x", shape=[4 * H], dtype="float32",
                            lod_level=1, stop_gradient=False)
        proj, cell = pkg.layers.dynamic_lstmp(
            x, size=4 * H, proj_size=3, use_peepholes=peep,
            is_reverse=reverse)
        backward(pkg, weighted_sum(pkg, [proj, cell], ["gp", "gc"]))
        return [proj, cell, grad_var_name("x")] + [
            grad_var_name(p.name) for p in
            pkg.default_main_program().all_parameters()]

    rng = np.random.RandomState(8)
    feed = seq_feed(rng, 4 * H, True)
    feed.update(gp=rand(rng, B, T, 3), gc=rand(rng, B, T, H))
    run_both(build, [feed], fwd=2)


@pytest.mark.parametrize("reverse,init", [(False, False), (True, True)])
def test_gru_op_matches_jax(reverse, init):
    def build(pkg):
        x = pkg.layers.data("x", shape=[3 * H], dtype="float32",
                            lod_level=1, stop_gradient=False)
        h0 = pkg.layers.data("h0", shape=[H], dtype="float32",
                             stop_gradient=False) if init else None
        hid = pkg.layers.dynamic_gru(x, size=H, is_reverse=reverse, h_0=h0)
        backward(pkg, weighted_sum(pkg, [hid], ["gh"]))
        return [hid, grad_var_name("x")] + ([grad_var_name("h0")]
                                            if init else []) + [
            grad_var_name(p.name) for p in
            pkg.default_main_program().all_parameters()]

    rng = np.random.RandomState(9)
    feed = seq_feed(rng, 3 * H, True)
    feed["gh"] = rand(rng, B, T, H)
    if init:
        feed["h0"] = rand(rng, B, H)
    run_both(build, [feed], fwd=1)


def test_lstm_unit_and_gru_unit_match_jax():
    def build(pkg):
        x, h, c = (pkg.layers.data(n, shape=[H], dtype="float32",
                                   stop_gradient=False)
                   for n in ("x", "h", "c"))
        h1, c1 = pkg.layers.lstm_unit(x, h, c, forget_bias=0.5)
        gin = pkg.layers.data("gin", shape=[3 * H], dtype="float32",
                              stop_gradient=False)
        h2, rhp, gate = pkg.layers.gru_unit(gin, h1, size=3 * H)
        backward(pkg, weighted_sum(pkg, [h1, c1, h2, gate],
                                   ["g1", "g2", "g3", "g4"]))
        return [h1, c1, h2, rhp, gate] + [
            grad_var_name(n) for n in ("x", "h", "c", "gin")] + [
            grad_var_name(p.name) for p in
            pkg.default_main_program().all_parameters()]

    rng = np.random.RandomState(10)
    feed = {n: rand(rng, B, H) for n in ("x", "h", "c", "g1", "g2", "g3")}
    feed.update(gin=rand(rng, B, 3 * H), g4=rand(rng, B, 3 * H))
    run_both(build, [feed], fwd=5)


# ---------------------------------------------------------------------------
# softmax_with_cross_entropy: soft labels and ignore_index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("soft,ignore,eps", [
    (True, -100, 0.0), (False, 2, 0.0), (False, -1, 0.0), (False, 3, 0.1)])
def test_softmax_xent_soft_label_and_ignore_index(soft, ignore, eps):
    """Loss, softmax and the logits' gradient: soft labels, an ignored
    label (-1 included), an ignored label with smoothing; an ignored row
    has loss 0 and no gradient."""
    n, c = 6, 5

    def build(pkg):
        logits = pkg.layers.data("logits", shape=[c], dtype="float32",
                                 stop_gradient=False)
        label = pkg.layers.data("label", shape=[c if soft else 1],
                                dtype="float32" if soft else "int64")
        loss, sm = pkg.layers.softmax_with_cross_entropy(
            logits, label, soft_label=soft, ignore_index=ignore,
            return_softmax=True, label_smooth_eps=eps)
        backward(pkg, pkg.layers.mean(loss))
        return [loss, sm, grad_var_name("logits")]

    rng = np.random.RandomState(11)
    feed = {"logits": rand(rng, n, c, scale=2.0)}
    if soft:
        p = rng.rand(n, c).astype("float32")
        feed["label"] = p / p.sum(axis=1, keepdims=True)
    else:
        lab = rng.randint(0, c, (n, 1)).astype("int64")
        lab[lab == ignore] = (ignore + 1) % c
        lab[[1, 4]] = ignore
        feed["label"] = lab
    ((loss, _, g),), _, _ = run_both(build, [feed], fwd=2)
    if not soft:
        assert np.all(loss[[1, 4]] == 0) and np.all(g[[1, 4]] == 0)
        assert np.all(loss[[0, 2, 3, 5]] > 0)
