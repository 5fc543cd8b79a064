"""The port's quantization-aware training (``contrib.QuantizeTranspiler``)
held against the JAX package on the CPU: ``training_transpile`` before
``minimize`` rewrites the program into the JAX package's, op for op; three
SGD steps from the JAX startup state give its losses, parameters and
running scales; ``freeze_program`` gives its frozen program, which uses the
trained scale and never moves it; ``convert_to_int8`` its int8 weights and
scales.  ``tests/test_quantize_transpiler.py``'s cases on the port."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib.quantize import QuantizeTranspiler as JaxQT

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler as PtQT
from paddle_tpu_torch.convert import load_numpy_state

from test_torch_serving import fresh_torch_programs  # noqa: F401

QT = {fluid: JaxQT, pt: PtQT}


def build(pkg, qt_kwargs):
    """``tests/test_quantize_transpiler.py``'s net: conv 3x3 (4 filters,
    ReLU, no bias) -> global avg pool -> fc 3 softmax, mean cross
    entropy, SGD(0.05), transpiled before minimize."""
    qt = QT[pkg](**qt_kwargs)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 6
    with pkg.program_guard(main, startup), pkg.unique_name.guard("q_"):
        img = pkg.layers.data("img", shape=[1, 8, 8])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        conv = pkg.layers.conv2d(img, 4, 3, padding=1, act="relu",
                                 bias_attr=False)
        pool = pkg.layers.pool2d(conv, 8, pool_type="avg",
                                 global_pooling=True)
        pred = pkg.layers.fc(pool, size=3, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        inserted = qt.training_transpile(main, startup)
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return qt, main, startup, loss, pred, inserted


def feeds(n, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = scale * rng.rand(8, 1, 8, 8).astype("float32")
        y = (x.mean(axis=(1, 2, 3)) > 0.5 * scale).astype("int64")
        out.append({"img": x, "label": y.reshape(-1, 1)})
    return out


CONFIGS = {
    "abs_max": {},
    "act_range_abs_max": {"activation_quantize_type": "range_abs_max"},
    "range_abs_max": {"activation_quantize_type": "range_abs_max",
                      "weight_quantize_type": "range_abs_max"},
    "per_channel": {"weight_quant_axis": "auto"},
}


def scale_names(main):
    return [op.outputs["OutScale"][0] for op in main.global_block().ops
            if op.type.startswith("fake_quantize")]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_qat_follows_jax(config):
    """The rewritten main and startup programs equal the JAX package's;
    three SGD steps from its startup state: the losses within rtol 1e-4,
    then every parameter and running scale within rtol 1e-4; the frozen
    program equal too, its predictions within rtol 1e-4 on data 100x the
    training range, and the running scales the same bits before and after
    it; ``convert_to_int8``'s scales within rtol 1e-5 and its int8 values
    equal (the rounding may differ by one step where a value lies within
    rounding of a half step: at most 1 apart)."""
    kw = CONFIGS[config]
    jqt, jm, js, jl, jp, jn = build(fluid, kw)
    pqt, pm, ps, pl, pp, pn = build(pt, kw)
    assert pn == jn >= 4
    assert pm.to_dict() == jm.to_dict()
    assert ps.to_dict() == js.to_dict()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    for f in feeds(3):
        (want,) = jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)
        (got,) = pexe.run(pm, feed=f, fetch_list=[pl], scope=pscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4)
    persist = [v.name for v in pm.list_vars() if v.persistable]
    assert set(scale_names(pm)) & set(persist) or \
        "range" not in str(kw)
    for n in persist:
        np.testing.assert_allclose(pscope.var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-7, err_msg=n)

    jf = jqt.freeze_program(jm, fluid.CPUPlace(), scope=jscope)
    pf = pqt.freeze_program(pm, pt.CPUPlace(), scope=pscope)
    assert pf.to_dict() == jf.to_dict()
    running = [n for n in scale_names(pm) if n in persist]
    before = {n: pscope.var(n).clone() for n in running}
    (big,) = feeds(1, seed=5, scale=100.0)
    (want,) = jexe.run(jf, feed=big, fetch_list=[jp.name], scope=jscope)
    (got,) = pexe.run(pf, feed=big, fetch_list=[pp.name], scope=pscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6)
    for n in running:
        assert bool((pscope.var(n) == before[n]).all()), n

    jconv = jqt.convert_to_int8(jm, scope=jscope)
    pconv = pqt.convert_to_int8(pm, scope=pscope)
    assert sorted(pconv) == sorted(jconv) and pconv
    for name, (iname, scale) in pconv.items():
        np.testing.assert_allclose(scale, jconv[name][1], rtol=1e-5)
        q = pscope.var(iname).numpy()
        assert q.dtype == np.int8
        qj = np.asarray(jscope.find_var(iname))
        assert np.abs(q.astype(int) - qj.astype(int)).max() <= 1
        assert (q == qj).mean() > 0.95
        np.testing.assert_allclose(
            pscope.var(iname + "_scale").numpy(),
            np.asarray(jscope.find_var(iname + "_scale")), rtol=1e-5)


def test_transpile_after_backward_rejected():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4])
        loss = pt.layers.mean(pt.layers.fc(x, size=2))
        pt.optimizer.SGD(0.1).minimize(loss)
        with pytest.raises(ValueError, match="BEFORE append_backward"):
            PtQT().training_transpile(main, startup)


def test_qat_trains_and_converts():
    """25 steps of ``tests/test_quantize_transpiler.py``'s run on the
    port: the loss falls, the running activation scale is learned
    (positive), and each int8 weight times its scale is the float weight
    within a hundredth of the scale."""
    qt, main, startup, loss, pred, _ = build(pt, CONFIGS[
        "act_range_abs_max"])
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0][0]) for f in feeds(25)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    running = [n for n in scale_names(main)
               if main.global_block()._find_var_recursive(n).persistable]
    assert running and float(scope.var(running[0])[0]) > 0
    for name, (iname, scale) in qt.convert_to_int8(
            main, scope=scope).items():
        q = scope.var(iname).numpy()
        assert q.dtype == np.int8 and scale > 0
        np.testing.assert_allclose(q.astype(np.float32) * scale / 127.0,
                                   scope.var(name).numpy(),
                                   atol=scale / 100)


def test_freeze_with_fused_batch_norm_is_refused():
    qt = build(pt, {})[0]
    with pytest.raises(NotImplementedError, match="InferenceTranspiler"):
        qt.freeze_program(pt.Program(), pt.CPUPlace(), fuse_bn=True)
