"""SE-ResNeXt after ``convert_to_nhwc`` then ``fuse_conv_bn`` held against
the JAX package on the CPU.

At full width (bench.py's SE-ResNeXt-50, 224 x 224, 1000 classes) the
train program and its startup program equal the JAX package's op for op:
50 transposes (49 with a grad op), 33 NHWC ``bn_act_conv2d`` and 16
grouped NHWC convolutions.  At narrow width (``test_torch_zoo``'s
``se_blocks``: a 3x3 stem and two bottlenecks of cardinality 4) one
Momentum step from the JAX startup state follows JAX within
``test_one_step_follows_jax``'s bands.  The batch norms run momentum 1.0
there: the JAX fused backward folds the statistics with the running mean
its ``bn_update_stats`` has already rewritten (ROADMAP Queue C), which
equals the mean the forward saw only when the update keeps the old value
(``test_torch_amp.py`` does the same)."""

import numpy as np

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_numpy_state

from test_torch_serving import fresh_torch_programs  # noqa: F401
from test_torch_zoo import LADDER, MODS, rel_l2, se_blocks


def _nhwc_fuse(pkg, main):
    """The two passes in bench.py's order; returns their counts."""
    return (pkg.transpiler.convert_to_nhwc(main),
            pkg.transpiler.fuse_conv_bn(main))


def _full_width(pkg):
    fn, size, classes = LADDER["se_resnext50"]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("img", shape=[3, size, size])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        pred = fn(MODS[pkg])(img, class_dim=classes)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        counts = _nhwc_fuse(pkg, main)
        pkg.optimizer.Momentum(learning_rate=1e-3,
                               momentum=0.9).minimize(loss)
    return main, startup, counts


def test_full_width_program_equals_jax():
    jm, js, jc = _full_width(fluid)
    pm, ps, pc = _full_width(pt)
    assert pc == jc == (53, 53)
    assert pm.to_dict() == jm.to_dict()
    assert ps.to_dict() == js.to_dict()
    ops = pm.global_block().ops
    types = [op.type for op in ops]
    assert types.count("transpose") == 50
    assert types.count("transpose_grad") == 49
    fused = [op for op in ops if op.type == "bn_act_conv2d"]
    assert len(fused) == 33 and types.count("bn_act_conv2d_grad") == 33
    assert all(op.attrs.get("data_format") == "NHWC" for op in fused)
    grouped = [op for op in ops if op.type == "conv2d"
               and (op.attrs.get("groups") or 1) > 1]
    assert len(grouped) == 16
    assert all(op.attrs.get("data_format") == "NHWC" for op in grouped)


def _narrow(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.program_guard(main, startup), pkg.unique_name.guard("z_"):
        img = pkg.layers.data("img", shape=[3, 12, 12])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        pred = se_blocks(pkg, img, 10)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                op.attrs["momentum"] = 1.0
            elif op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
        counts = _nhwc_fuse(pkg, main)
        pkg.optimizer.Momentum(learning_rate=1e-2,
                               momentum=0.9).minimize(loss)
    return main, startup, loss, counts


def test_one_step_follows_jax():
    """Two Momentum steps at batch 4 from the JAX startup state: the losses
    within rtol 1e-4, every parameter gradient of the first step within
    relative L2 1e-4 plus 1e-5 on the distance, every parameter after the
    second within rtol 1e-4 (atol 1e-6), as ``test_one_step_follows_jax``
    holds the NCHW nets."""
    jm, js, jl, jc = _narrow(fluid)
    pm, ps, pl, pc = _narrow(pt)
    assert pc == jc == (8, 8)
    assert pm.to_dict() == jm.to_dict()
    types = [op.type for op in pm.global_block().ops]
    assert "bn_act_conv2d" in types and "transpose" in types
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    rng = np.random.RandomState(0)
    grads = [p.name + "@GRAD" for p in pm.all_parameters() if p.trainable]
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for step in range(2):
        feed = {"img": rng.rand(4, 3, 12, 12).astype("float32"),
                "label": rng.randint(0, 10, (4, 1)).astype("int64")}
        fetch = [jl] + (grads if step == 0 else [])
        want = [np.asarray(v) for v in jexe.run(jm, feed=feed,
                                                fetch_list=fetch,
                                                scope=jscope)]
        got = pexe.run(pm, feed=feed, fetch_list=[pl] + fetch[1:],
                       scope=pscope)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        for n, g, w in zip(grads, got[1:], want[1:]):
            dist = float(np.linalg.norm(np.asarray(g, np.float64) - w))
            assert dist <= 1e-4 * np.linalg.norm(w) + 1e-5, \
                (n, rel_l2(g, w), dist)
    for p in pm.all_parameters():
        np.testing.assert_allclose(pscope.var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-4, atol=1e-6, err_msg=p.name)
