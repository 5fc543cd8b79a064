"""The port's optimizers, learning-rate schedules and ModelAverage held
against the JAX package on the CPU, from the JAX startup state: the ten
optimizers of ``tests/test_optimizers.py`` (and RMSProp centered with
momentum, Ftrl at another power with l1/l2), the proximal update ops, each
schedule's in-graph rate (``staircase`` and ``cycle`` included),
``append_LARS``, the ``average_accumulates`` window and ``ModelAverage``
across window restarts, and what a SelectedRows gradient does to the
dense-only updates.  Trajectories are held at rtol 1e-4, the band of the
reference's own optimizer tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.ops import optimizer_ops as jax_opt

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.ops import optimizer_ops as pt_opt

from test_torch_serving import fresh_torch_programs  # noqa: F401

RTOL = 1e-4


def build(pkg, net, seed=3):
    """(main, startup, fetches) of ``net(pkg)`` in fresh programs."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard("o_"):
        fetches = net(pkg)
    return main, startup, fetches


def run_both(net, feeds):
    """Run ``net`` in both packages from the JAX startup state over
    ``feeds``; ([JAX fetches a step], [port fetches a step], JAX scope,
    port scope, the port's main program)."""
    jm, js, jf = build(fluid, net)
    pm, ps, pf = build(pt, net)
    assert pm.to_dict() == jm.to_dict()
    assert ps.to_dict() == js.to_dict()
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    want, got = [], []
    for f in feeds:
        want.append([np.asarray(v) for v in
                     jexe.run(jm, feed=f, fetch_list=jf, scope=jscope)])
        got.append([np.asarray(v) for v in
                    pexe.run(pm, feed=f, fetch_list=pf, scope=pscope)])
    return want, got, jscope, pscope, pm


def assert_state_close(jscope, pscope, program, rtol=RTOL, atol=1e-6):
    for v in program.list_vars():
        if v.persistable and pscope.has_var(v.name):
            np.testing.assert_allclose(
                pscope.var(v.name).numpy(),
                np.asarray(jscope.find_var(v.name)), rtol=rtol, atol=atol,
                err_msg=v.name)


OPTIMIZERS = {
    "sgd": lambda o: o.SGD(learning_rate=0.05),
    "momentum": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9),
    "nesterov": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9,
                                     use_nesterov=True),
    "adagrad": lambda o: o.Adagrad(learning_rate=0.3),
    "adam": lambda o: o.Adam(learning_rate=0.1),
    "adamax": lambda o: o.Adamax(learning_rate=0.1),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(learning_rate=0.3),
    "adadelta": lambda o: o.Adadelta(learning_rate=1.0, rho=0.95),
    "rmsprop": lambda o: o.RMSProp(learning_rate=0.05),
    "ftrl": lambda o: o.Ftrl(learning_rate=0.5),
    "rmsprop_centered": lambda o: o.RMSProp(learning_rate=0.01, momentum=0.9,
                                            centered=True),
    "ftrl_power": lambda o: o.Ftrl(learning_rate=0.5, l1=0.01, l2=0.1,
                                   lr_power=-0.6),
}


def quadratic(make_opt):
    """``tests/test_optimizers.py``'s problem: mean((x @ w0)^2), w0 = 1."""
    def net(pkg):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.fc(x, size=1, bias_attr=False, param_attr=pkg.ParamAttr(
            name="w0", initializer=pkg.initializer.ConstantInitializer(1.0)))
        loss = pkg.layers.mean(pkg.layers.square(y))
        make_opt(pkg.optimizer).minimize(loss)
        return [loss]

    return net


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_follows_jax(name):
    """25 steps on the quadratic: every loss and, after them, the
    parameter and every accumulator within rtol 1e-4; the loss falls by
    10% (the JAX test's criterion)."""
    xv = np.random.RandomState(0).uniform(0.5, 1.5, (16, 4)).astype(
        "float32")
    want, got, jscope, pscope, pm = run_both(quadratic(OPTIMIZERS[name]),
                                             [{"x": xv}] * 25)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=RTOL)
    assert_state_close(jscope, pscope, pm)
    assert float(got[-1][0][0]) < 0.9 * float(got[0][0][0])


def mlp(make_opt, with_lr=None):
    """A 6-8-3 softmax MLP (biases, a ReLU) under ``make_opt``;
    ``with_lr(layers)`` builds a schedule that the optimizer takes."""
    def net(pkg):
        x = pkg.layers.data("x", shape=[6])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=8, act="relu")
        pred = pkg.layers.fc(h, size=3, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        lr = with_lr(pkg.layers) if with_lr else None
        make_opt(pkg.optimizer, lr).minimize(loss)
        return [loss] + ([lr] if lr is not None else [])

    return net


def mlp_feeds(steps, seed=1, batch=16):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, 6).astype("float32"),
             "label": rng.randint(0, 3, (batch, 1)).astype("int64")}
            for _ in range(steps)]


SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 4, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 4, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.5, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 4, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 4, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 5, 0.01,
                                                     power=2.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 6], [0.1, 0.01, 0.001]),
    "noam": lambda L: L.noam_decay(d_model=64, warmup_steps=4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_trajectory_follows_jax(name):
    """Momentum(schedule, 0.9) on the MLP for 14 steps (past the
    staircase and cycle boundaries): the rate and the loss at every step
    within rtol 1e-4, then every parameter, velocity and the step
    counter."""
    net = mlp(lambda o, lr: o.Momentum(learning_rate=lr, momentum=0.9),
              with_lr=SCHEDULES[name])
    want, got, jscope, pscope, pm = run_both(net, mlp_feeds(14))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[1], w[1], rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL)
    assert_state_close(jscope, pscope, pm)
    rates = [float(g[1].ravel()[0]) for g in got]
    assert len(set(rates)) > 1, rates


def test_learning_rate_decay_module_is_the_schedules():
    assert pt.learning_rate_decay.__all__ == \
        fluid.learning_rate_decay.__all__
    assert pt.learning_rate_decay.polynomial_decay is \
        pt.layers.polynomial_decay


@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
def test_append_lars_follows_jax(lr_kind):
    """``append_LARS`` on the MLP's parameters (a float rate, and an
    exponential schedule) then SGD: the per-parameter rates and the losses
    over 10 steps within rtol 1e-4."""
    def net(pkg):
        x = pkg.layers.data("x", shape=[6])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=8, act="relu")
        pred = pkg.layers.fc(h, size=3, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        params_grads = pkg.backward.append_backward(loss)
        lr = 0.5 if lr_kind == "float" else \
            pkg.layers.exponential_decay(0.5, 4, 0.5)
        decayed = pkg.layers.append_LARS(params_grads, lr,
                                         weight_decay=0.01)
        pkg.optimizer.SGD(learning_rate=0.1).apply_gradients(params_grads,
                                                             loss)
        return [loss] + decayed

    want, got, jscope, pscope, pm = run_both(net, mlp_feeds(10))
    for w, g in zip(want, got):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=RTOL)
    assert_state_close(jscope, pscope, pm)
    assert float(got[-1][0][0]) < float(got[0][0][0])


@pytest.mark.parametrize("op_type", ["proximal_gd", "proximal_adagrad"])
def test_proximal_update_ops_follow_jax(op_type):
    """The proximal updates (no optimizer class in either package) as
    one-op programs fed the parameter, gradient, moment and rate, with l1
    and l2: the outputs within rtol 1e-5 over values near the l1
    threshold."""
    rng = np.random.RandomState(4)
    feed = {"p": rng.randn(5, 7).astype("float32"),
            "g": rng.randn(5, 7).astype("float32"),
            "m": rng.rand(5, 7).astype("float32") + 0.1,
            "lr": np.array([0.3], "float32")}
    outs = {}
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            block = main.global_block()
            for n in feed:
                block.create_var(name=n, shape=feed[n].shape,
                                 dtype="float32", is_data=True)
            inputs = {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]}
            outputs = {"ParamOut": ["p_out"]}
            if op_type == "proximal_adagrad":
                inputs["Moment"] = ["m"]
                outputs["MomentOut"] = ["m_out"]
            block.append_op(type=op_type, inputs=inputs, outputs=outputs,
                            attrs={"l1": 0.2, "l2": 0.5})
        exe = pkg.Executor(pkg.CPUPlace())
        outs[pkg] = [np.asarray(v) for v in exe.run(
            main, feed={k: v.copy() for k, v in feed.items()},
            fetch_list=sorted(n for v in outputs.values() for n in v))]
    for a, b in zip(outs[pt], outs[fluid]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert (outs[pt][-1] == 0).any()      # the l1 threshold bit


def test_average_accumulates_window_restart_follows_jax():
    """``tests/test_misc_ops_r3.py``'s case on both packages: the window
    restarts once num_accumulates reaches min(max_average_window,
    num_updates * average_window) and min_average_window; and a roll of
    sum_1 into sum_2 at 16384 updates."""
    for nu, na, want_na in ((5, 1, 0), (16383, 0, 1)):
        outs = {}
        for pkg in (fluid, pt):
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                block = main.global_block()
                for n in ("param", "s1", "s2", "s3"):
                    block.create_var(name=n, shape=(3,), dtype="float32",
                                     is_data=True)
                for n in ("na", "ona", "nu"):
                    block.create_var(name=n, shape=(1,), dtype="int64",
                                     is_data=True)
                block.append_op(
                    type="average_accumulates",
                    inputs={"param": ["param"], "in_sum_1": ["s1"],
                            "in_sum_2": ["s2"], "in_sum_3": ["s3"],
                            "in_num_accumulates": ["na"],
                            "in_old_num_accumulates": ["ona"],
                            "in_num_updates": ["nu"]},
                    outputs={"out_sum_1": ["o1"], "out_sum_2": ["o2"],
                             "out_sum_3": ["o3"],
                             "out_num_accumulates": ["ona2"],
                             "out_old_num_accumulates": ["oona"],
                             "out_num_updates": ["onu"]},
                    attrs={"average_window": 1.0, "min_average_window": 2,
                           "max_average_window": 2 if nu == 5 else 100})
            feed = {"param": np.full((3,), 2.0, "float32"),
                    "s1": np.ones((3,), "float32"),
                    "s2": np.full((3,), 0.5, "float32"),
                    "s3": np.zeros((3,), "float32"),
                    "na": np.array([na], "int64"),
                    "ona": np.array([0], "int64"),
                    "nu": np.array([nu], "int64")}
            outs[pkg] = [np.asarray(v) for v in pkg.Executor(
                pkg.CPUPlace()).run(main, feed=feed, fetch_list=[
                    "o1", "o2", "o3", "ona2", "oona", "onu"])]
        for a, b in zip(outs[pt], outs[fluid]):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        assert int(outs[pt][3][0]) == want_na
        assert outs[pt][3].dtype == np.int64


def test_model_average_across_window_restarts_follows_jax():
    """SGD on the MLP with ``ModelAverage(0.5, min 2, max 3)``: the
    window restarts every few steps; after each of 9 steps the averages
    ``apply()`` swaps in and a fetch of the forward inside the block
    within rtol 1e-5 of the JAX package's, the parameters restored after
    it, and the average what the window protocol gives by hand."""
    mas, fetch, tests = {}, {}, {}

    def net(pkg):
        x = pkg.layers.data("x", shape=[6])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=8, act="relu")
        pred = pkg.layers.fc(h, size=3, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        # the evaluation program: the forward, cloned before minimize
        tests[pkg] = pkg.default_main_program().clone(for_test=True)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
        ma = pkg.optimizer.ModelAverage(average_window_rate=0.5,
                                        min_average_window=2,
                                        max_average_window=3)
        ma._ensure_accumulators(pkg.default_main_program())
        mas[pkg] = ma
        fetch[pkg] = pred
        return [loss]

    jm, js, jf = build(fluid, net)
    pm, ps, pf = build(pt, net)
    assert pm.to_dict() == jm.to_dict()
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jtest, ptest = tests[fluid], tests[pt]
    names = [p.name for p in pm.all_parameters()]
    history, restarts = [], 0
    cur_sum, n_cur, old_sum, n_old = 0.0, 0, 0.0, 0
    for f in mlp_feeds(9):
        (jl,) = jexe.run(jm, feed=f, fetch_list=jf, scope=jscope)
        (pl,) = pexe.run(pm, feed=f, fetch_list=pf, scope=pscope)
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=RTOL)
        history.append({n: pscope.var(n).numpy().copy() for n in names})
        with fluid.scope_guard(jscope), mas[fluid].apply(jexe, jscope):
            javg = {n: np.array(jscope.find_var(n), copy=True)
                    for n in names}
            (jp,) = jexe.run(jtest, feed=f, fetch_list=[fetch[fluid].name],
                             scope=jscope)
        with mas[pt].apply(pexe, pscope):
            pavg = {n: pscope.var(n).numpy().copy() for n in names}
            (pp,) = pexe.run(ptest, feed=f, fetch_list=[fetch[pt].name],
                             scope=pscope)
        for n in names:
            np.testing.assert_allclose(pavg[n], javg[n], rtol=1e-5,
                                       atol=1e-7, err_msg=n)
            np.testing.assert_array_equal(pscope.var(n).numpy(),
                                          history[-1][n])
        np.testing.assert_allclose(pp, np.asarray(jp), rtol=1e-5)
        # the protocol by hand: a restart keeps the window's sum from
        # before its last update (as the reference's op does) over the
        # window's full count
        prev = cur_sum
        cur_sum, n_cur = cur_sum + history[-1][names[0]], n_cur + 1
        if n_cur >= 2 and n_cur >= min(3, int(len(history) * 0.5)):
            old_sum, n_old, cur_sum, n_cur = prev, n_cur, 0.0, 0
            restarts += 1
        np.testing.assert_allclose(
            pavg[names[0]], (cur_sum + old_sum) / max(n_cur + n_old, 1),
            rtol=1e-5, atol=1e-7)
    assert restarts >= 2, restarts


@pytest.mark.parametrize("name", ["adamax", "decayed_adagrad", "adadelta",
                                  "rmsprop", "ftrl"])
def test_sparse_gradient_raises_as_in_jax(name):
    """An ``is_sparse`` embedding's SelectedRows gradient reaching a
    dense-only update: the JAX package fails with a TypeError inside the
    op's arithmetic; the port raises a TypeError naming the op."""
    def net(pkg):
        ids = pkg.layers.data("ids", shape=[1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[10, 4], is_sparse=True)
        loss = pkg.layers.mean(emb)
        OPTIMIZERS[name](pkg.optimizer).minimize(loss)
        return [loss]

    feed = {"ids": np.array([[1], [2], [1]], "int64")}
    for pkg in (fluid, pt):
        main, startup, fetches = build(pkg, net)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        with pytest.raises(TypeError) as err:
            exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
        if pkg is pt:
            assert name in str(err.value)
            assert "SelectedRows" in str(err.value)


def _rounding_case(name, rng, n=20000):
    """(op type, inputs, attrs, slots held bit for bit) of one update on
    gradients from 1e-9 to 1e-1 and moments of a running optimizer."""
    def vec(scale):
        return (rng.randn(n) * scale).astype("float32")

    grad = (rng.randn(n) * 10.0 ** rng.uniform(-9, -1, n)).astype("float32")
    ins = {"Param": vec(0.1), "Grad": grad,
           "LearningRate": np.array([1e-2], "float32")}
    if name in ("momentum", "nesterov"):
        ins["Velocity"] = vec(1e-3)
        return ("momentum", ins, {"mu": 0.9, "use_nesterov": name ==
                                  "nesterov"}, ("VelocityOut", "ParamOut"))
    if name == "adagrad":
        ins["Moment"] = (rng.rand(n) * 1e-6).astype("float32")
        return "adagrad", ins, {"epsilon": 1e-6}, ("MomentOut", "ParamOut")
    if name == "adamax":
        ins.update(Moment=vec(1e-4),
                   InfNorm=(rng.rand(n) * 1e-3).astype("float32"),
                   Beta1Pow=np.array([0.9 ** 3], "float32"))
        return "adamax", ins, {}, ("MomentOut", "InfNormOut", "ParamOut")
    ins.update(MeanGrad=vec(1e-4), Moment=vec(1e-4))
    ins["MeanSquare"] = (ins["MeanGrad"] ** 2
                         + rng.rand(n) * 1e-6).astype("float32")
    centered = name == "rmsprop_centered"
    return ("rmsprop", ins, {"decay": 0.9, "epsilon": 1e-10,
                             "momentum": 0.9, "centered": centered},
            ("MeanSquareOut",) + (("MeanGradOut",) if centered else ()))


@pytest.mark.parametrize("name", ["momentum", "nesterov", "adagrad",
                                  "adamax", "rmsprop", "rmsprop_centered"])
def test_update_rounds_like_the_jitted_jax_op(name):
    """The port's dense update on CPU tensors against the JAX op jitted as
    its executor runs it (XLA contracts each ``a * m + b * g`` into one
    multiply-add), bit for bit.  RMSProp's momentum and parameter are the
    exception the module's docstring names: XLA multiplies by the CPU's
    ``rsqrt`` estimate, one ulp off for some inputs, so they are held to
    what that ulp can move, ``2^-22`` of ``lr * g * rsqrt(.)`` plus an
    ulp of the result."""
    op, ins, attrs, exact = _rounding_case(name, np.random.RandomState(5))
    jax_fn = getattr(jax_opt, "_%s_compute" % op)
    want = jax.jit(lambda d: jax_fn({k: [v] for k, v in d.items()}, attrs,
                                    None, 0))(
        {k: jnp.asarray(v) for k, v in ins.items()})
    got = getattr(pt_opt, "_%s_compute" % op)(
        {k: [torch.from_numpy(v.copy())] for k, v in ins.items()}, attrs,
        None, 0)
    for slot in exact:
        np.testing.assert_array_equal(got[slot].numpy(),
                                      np.asarray(want[slot]), err_msg=slot)
    if op != "rmsprop":
        assert set(exact) == set(want)
        return
    ms = np.asarray(want["MeanSquareOut"], np.float64)
    if attrs["centered"]:
        ms = ms - np.asarray(want["MeanGradOut"], np.float64) ** 2
    term = np.abs(1e-2 * ins["Grad"].astype(np.float64) / np.sqrt(ms + 1e-10))
    for slot in ("MomentOut", "ParamOut"):
        a = got[slot].numpy()
        b = np.asarray(want[slot])
        ulp = np.spacing(np.abs(b)).astype(np.float64)
        assert (np.abs(a.astype(np.float64) - b) <= term * 2.0 ** -22
                + ulp).all(), slot
