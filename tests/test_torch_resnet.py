"""The port's ResNet training slice held against the JAX package on the
CPU: program parity of the full ResNet-50 train program (plain,
``fuse_conv_bn``, ``convert_to_nhwc`` + ``fuse_conv_bn``), Momentum
trajectories from the JAX startup state, the fused backward's stats shift,
and the executor's dead-op skipping.

The JAX package's fused grad op folds the stats cotangents with the
running mean *after* ``bn_update_stats`` has moved it (the fusion pass
wires ``StatsShift`` to the BN's running-mean variable, which the update
rewrites under the same name), so its fused gradients drift from the
unfused ones whenever the running mean moves; the port folds with the
shift its forward used.  ``test_fused_gradients_fold_with_the_forward_shift``
holds both facts.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import resnet as jax_resnet

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as pt_registry
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.models import resnet as pt_resnet

from test_torch_serving import fresh_torch_programs  # noqa: F401

RESNET = {fluid: jax_resnet, pt: pt_resnet}


def bottleneck_net(pkg, bn_momentum=0.9):
    """The net of ``tests/test_conv_bn_fusion.py`` and
    ``tests/test_layout_pass.py``: 1x1 -> bn+relu -> 1x1 -> bn+relu -> 3x3
    -> bn, a residual add, global pool, fc.  The pass sees an absorbed
    conv, a stats-producing conv, an un-absorbed (3x3) consumer and a
    multi-consumer bn output."""
    img = pkg.layers.data("img", shape=[8, 6, 6])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    c1 = pkg.layers.conv2d(img, num_filters=16, filter_size=1,
                           bias_attr=False)
    b1 = pkg.layers.batch_norm(c1, act="relu", momentum=bn_momentum)
    c2 = pkg.layers.conv2d(b1, num_filters=8, filter_size=1, bias_attr=False)
    b2 = pkg.layers.batch_norm(c2, act="relu", momentum=bn_momentum)
    c3 = pkg.layers.conv2d(b2, num_filters=8, filter_size=3, padding=1,
                           bias_attr=False)
    b3 = pkg.layers.batch_norm(c3, act=None, momentum=bn_momentum)
    res = pkg.layers.elementwise_add(x=b3, y=img, act="relu")
    pool = pkg.layers.pool2d(res, pool_size=6, pool_type="avg",
                             global_pooling=True)
    pred = pkg.layers.fc(pool, size=5, act="softmax")
    return pkg.layers.mean(pkg.layers.cross_entropy(pred, label)), b1


def resnet18_net(pkg, bn_momentum=0.9):
    """``test_imagenet_bottleneck_parity``'s net: resnet_imagenet depth 18
    on 3x32x32 (strided blocks and projection shortcuts)."""
    img = pkg.layers.data("img", shape=[3, 32, 32])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    pred = RESNET[pkg].resnet_imagenet(img, class_dim=10, depth=18)
    return pkg.layers.mean(pkg.layers.cross_entropy(pred, label)), None


def build(pkg, net, mode, lr=0.05, seed=7, bn_momentum=0.9):
    """(main, startup, loss, extra) with ``mode`` in plain / fuse / nhwc /
    nhwc_fuse, Momentum(lr, 0.9) appended after the passes."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard("t_"):
        loss, extra = net(pkg, bn_momentum)
        if "nhwc" in mode:
            assert pkg.transpiler.convert_to_nhwc(main) > 0
        if "fuse" in mode:
            assert pkg.transpiler.fuse_conv_bn(main) > 0
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return main, startup, loss, extra


def jax_start(startup):
    """A JAX scope after the startup program, and its persistable state as
    numpy arrays."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return scope, {v.name: np.array(scope.find_var(v.name), copy=True)
                   for v in startup.list_vars() if v.persistable}


def pt_start(startup, state):
    scope = pt.Scope()
    load_numpy_state(scope, startup, state, "cpu")
    return scope


def feeds(shape, classes, steps, seed=0, offset=0.0):
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(4, *shape).astype("float32") + offset,
             "label": rng.randint(0, classes, (4, 1)).astype("int64")}
            for _ in range(steps)]


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def grad_fetches(main):
    return [p.name + "@GRAD" for p in main.global_block().all_parameters()
            if p.trainable]


@pytest.mark.parametrize("mode", ["plain", "fuse", "nhwc_fuse"])
def test_resnet50_train_program_serializes_like_jax(mode):
    """bench.py's ResNet-50 (3x224x224, class_dim 1000, Momentum(1e-3,
    0.9)): main and startup, op for op and attr for attr; built, never
    run."""
    def net(pkg, bn_momentum):
        img = pkg.layers.data("img", shape=[3, 224, 224])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        pred = RESNET[pkg].resnet_imagenet(img, class_dim=1000, depth=50)
        return pkg.layers.mean(pkg.layers.cross_entropy(pred, label)), None

    jm, js, _, _ = build(fluid, net, mode, lr=1e-3)
    pm, ps, _, _ = build(pt, net, mode, lr=1e-3)
    assert pm.to_dict() == jm.to_dict()
    assert ps.to_dict() == js.to_dict()
    types = [op.type for op in pm.global_block().ops]
    fused = 30 if "fuse" in mode else 0
    assert types.count("bn_act_conv2d") == fused
    assert types.count("bn_act_conv2d_grad") == fused
    assert types.count("transpose") == (2 if "nhwc" in mode else 0)


@pytest.mark.parametrize("mode", ["plain", "nhwc"])
def test_momentum_trajectory_follows_jax(mode):
    """Four Momentum steps of the bottleneck net: the losses step by step,
    then every parameter, velocity and running statistic, within rtol
    1e-4 (float32 sums in another order, compounded over the steps), from
    the JAX startup state."""
    jm, js, jl, _ = build(fluid, bottleneck_net, mode)
    pm, ps, pl, _ = build(pt, bottleneck_net, mode)
    assert pm.to_dict() == jm.to_dict()
    jscope, state = jax_start(js)
    pscope = pt_start(ps, state)
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for f in feeds((8, 6, 6), 5, 4, seed=3):
        (want,) = jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)
        (got,) = pexe.run(pm, feed=f, fetch_list=[pl], scope=pscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4)
    for name in state:
        np.testing.assert_allclose(
            pscope.var(name).numpy(), np.asarray(jscope.find_var(name)),
            rtol=1e-4, atol=1e-5, err_msg=name)


def test_resnet18_step_follows_jax():
    """``test_imagenet_bottleneck_parity``'s depth-18 net after
    ``convert_to_nhwc`` (strided blocks, projection shortcuts, the NHWC
    trunk): the first Momentum step's loss within rtol 1e-4 and every
    parameter gradient within relative L2 1e-3, from the JAX startup
    state.

    One step, not a trajectory: at 3x32x32 the last stage's batch norms
    see 4 values a channel, and the net amplifies rounding.  Measured on
    the CPU with the JAX package alone: scaling each startup weight by (1
    + 1e-7 N(0, 1)) moves its step-1 gradients by 6.4e-5 relative L2 at
    the median, and by 1e-6 moves its third loss from 3.315 to 3.781.  The
    port's step-1 gradients differ from the JAX package's by 1.4e-4 at the
    median and 1.9e-4 at most (1.0e-4 and 1.3e-4 without the layout
    pass)."""
    jm, js, jl, _ = build(fluid, resnet18_net, "nhwc", lr=0.01)
    pm, ps, pl, _ = build(pt, resnet18_net, "nhwc", lr=0.01)
    assert pm.to_dict() == jm.to_dict()
    jscope, state = jax_start(js)
    pscope = pt_start(ps, state)
    names = grad_fetches(pm)
    (f,) = feeds((3, 32, 32), 10, 1, seed=3)
    want = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=f, fetch_list=[jl] + names, scope=jscope)
    got = pt.Executor(pt.CPUPlace()).run(pm, feed=f, fetch_list=[pl] + names,
                                         scope=pscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4)
    for name, g, w in zip(names, got[1:], want[1:]):
        assert rel_l2(g, w) < 1e-3, (name, rel_l2(g, w))


@pytest.mark.parametrize("nhwc", [False, True])
def test_fused_gradients_fold_with_the_forward_shift(nhwc):
    """One step from one startup state on a non-centred input (mean ~1.5,
    so the first step moves each running mean by a tenth of a batch mean
    well away from 0).  At BN momentum 0.9 the port's fused gradients
    equal the port's and the JAX package's unfused ones, and the JAX
    package's fused ones do not (2.04 relative L2 on the first conv's
    weight, CPU); at momentum 1.0 (the running mean stays put) the JAX
    fused gradients agree too.  Band: relative L2 1e-4 per parameter; the
    largest gap measured is 2.5e-5, the two packages' unfused gradients
    (the BN scales' gradients are differences of near-equal sums).  At a
    mean of ~6.5 that gap grows to 1.6e-4 between the two unfused
    programs alone, so the test stays at ~1.5."""
    pre = "nhwc_" if nhwc else ""
    (f,) = feeds((8, 6, 6), 5, 1, seed=1, offset=1.0)
    for momentum in (0.9, 1.0):
        grads = {}
        for pkg in (fluid, pt):
            for mode in ("plain", "fuse"):
                main, startup, loss, _ = build(pkg, bottleneck_net,
                                               pre + mode if mode == "fuse"
                                               else "plain",
                                               bn_momentum=momentum)
                if pkg is fluid:
                    scope, state = jax_start(startup)
                    exe = fluid.Executor(fluid.CPUPlace())
                else:
                    scope = pt_start(startup, state)
                    exe = pt.Executor(pt.CPUPlace())
                names = grad_fetches(main)
                out = exe.run(main, feed=f, fetch_list=[loss] + names,
                              scope=scope)
                grads[pkg, mode] = dict(zip(["loss"] + names,
                                            [np.asarray(o) for o in out]))
        port_fused = grads[pt, "fuse"]
        assert len(port_fused) > 5
        refs = [grads[pt, "plain"], grads[fluid, "plain"]]
        if momentum == 1.0:
            refs.append(grads[fluid, "fuse"])
        for ref in refs:
            for name, g in port_fused.items():
                assert rel_l2(g, ref[name]) < 1e-4, (momentum, name,
                                                     rel_l2(g, ref[name]))
        if momentum == 0.9:
            worst = max(rel_l2(grads[fluid, "fuse"][n], grads[fluid,
                                                                "plain"][n])
                        for n in port_fused)
            assert worst > 1e-2, worst


def test_executor_skips_dead_ops_and_computes_them_when_fetched(
        monkeypatch):
    """In the fused bottleneck net the first BN's re-emitted ``bn_apply``
    and ``relu`` have no reader: they do not run.  Fetching the absorbed
    relu's output runs them, and it equals the unfused program's."""
    ran = []
    real = pt_registry.compute_op

    def spy(op, env, ctx, op_index=0):
        ran.append((op.type, op_index))
        return real(op, env, ctx, op_index=op_index)

    monkeypatch.setattr(pt_registry, "compute_op", spy)
    main, startup, loss, b1 = build(pt, bottleneck_net, "fuse")
    types = [op.type for op in main.global_block().ops]
    (f,) = feeds((8, 6, 6), 5, 1)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    state = {n: scope.var(n).clone() for n in scope.local_var_names()}
    del ran[:]
    exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    run_types = [t for t, _ in ran]
    assert types.count("bn_apply") == 3 and run_types.count("bn_apply") == 2
    assert types.count("relu") == 3 and run_types.count("relu") == 2
    # the ops that ran kept their program index
    assert all(types[i] == t for t, i in ran)

    for n, v in state.items():
        scope.set_var(n, v.clone())
    del ran[:]
    got_loss, got_b1 = exe.run(main, feed=f, fetch_list=[loss, b1],
                               scope=scope)
    assert [t for t, _ in ran].count("relu") == 3
    plain, _, plain_loss, plain_b1 = build(pt, bottleneck_net, "plain")
    pscope = pt.Scope()
    for n, v in state.items():
        pscope.set_var(n, v.clone())
    want_loss, want_b1 = exe.run(plain, feed=f,
                                 fetch_list=[plain_loss, plain_b1],
                                 scope=pscope)
    assert (got_b1 >= 0).all()
    np.testing.assert_allclose(got_b1, want_b1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
