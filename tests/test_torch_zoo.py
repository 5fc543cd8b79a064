"""The port's image-model ladder held against the JAX package on the CPU:
bench.py's SmallNet, AlexNet, VGG-16, GoogLeNet and SE-ResNeXt-50, and
BASELINE's SE-ResNeXt-152, serialize op for op at full width (train and
inference programs, and SE-ResNeXt-50 after ``fuse_conv_bn``); the
activation table, ``lrn`` (odd and even windows), ``prelu``, ``maxout``
and ``log_softmax`` as one-op programs, forward and gradient; and one
Momentum step of SmallNet and AlexNet at small images, and of VGG's,
GoogLeNet's and SE-ResNeXt's blocks at narrow width, from the JAX startup
state (dropout set to 0 in both programs: the two packages draw different
masks)."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import (alexnet as j_alexnet, googlenet as j_googlenet,
                               se_resnext as j_se, smallnet as j_smallnet,
                               vgg as j_vgg)

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.models import (alexnet as p_alexnet,
                                     googlenet as p_googlenet,
                                     se_resnext as p_se,
                                     smallnet as p_smallnet, vgg as p_vgg)

from test_torch_serving import fresh_torch_programs  # noqa: F401

MODS = {fluid: dict(smallnet=j_smallnet, alexnet=j_alexnet, vgg=j_vgg,
                    googlenet=j_googlenet, se=j_se),
        pt: dict(smallnet=p_smallnet, alexnet=p_alexnet, vgg=p_vgg,
                 googlenet=p_googlenet, se=p_se)}

# bench.py's rungs (``bench.py:1788-1850``): builder, image size, classes
LADDER = {
    "smallnet": (lambda m: m["smallnet"].smallnet, 32, 10),
    "alexnet": (lambda m: m["alexnet"].alexnet, 227, 1000),
    "vgg16": (lambda m: m["vgg"].vgg16_bn_drop, 224, 1000),
    "googlenet": (lambda m: m["googlenet"].googlenet_v1, 224, 1000),
    "se_resnext50": (lambda m: m["se"].se_resnext_50, 224, 1000),
    "se_resnext152": (lambda m: lambda img, class_dim, is_test=False:
                      m["se"].SE_ResNeXt(img, class_dim=class_dim,
                                         depth=152, is_test=is_test),
                      224, 1000),
}


def build_rung(pkg, name, infer=False, fuse=False, size=None,
               class_dim=None):
    """bench.py's ``_bench_image_model`` program: train (mean cross
    entropy, Momentum(1e-3, 0.9)) or inference (is_test, the mean of the
    softmax); ``fuse`` runs ``fuse_conv_bn`` before minimize."""
    fn, full, classes = LADDER[name]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        s = size or full
        img = pkg.layers.data("img", shape=[3, s, s])
        pred = fn(MODS[pkg])(img, class_dim=class_dim or classes,
                             is_test=infer)
        if infer:
            loss = pkg.layers.mean(pred)
        else:
            label = pkg.layers.data("label", shape=[1], dtype="int64")
            loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
            if fuse:
                pkg.transpiler.fuse_conv_bn(main)
            pkg.optimizer.Momentum(learning_rate=1e-3,
                                   momentum=0.9).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("infer", [False, True], ids=["train", "infer"])
@pytest.mark.parametrize("name", sorted(LADDER))
def test_ladder_serializes_like_jax(name, infer):
    """Main and startup programs equal op for op and attr for attr at
    full width; built, never run."""
    jm, js, _ = build_rung(fluid, name, infer)
    pm, ps, _ = build_rung(pt, name, infer)
    assert pm.to_dict() == jm.to_dict()
    assert ps.to_dict() == js.to_dict()
    types = [op.type for op in pm.global_block().ops]
    if name.startswith("se_"):
        blocks = 16 if name == "se_resnext50" else 50
        assert types.count("sigmoid") == blocks
    if name == "alexnet":
        assert types.count("lrn") == 2


def test_fused_se_resnext50_serializes_like_jax():
    """``fuse_conv_bn`` before minimize: 33 fused layers (16 conv2s
    reading conv1's BN + ReLU, 16 conv0s, block 0's projection), each
    with its grad op, in both packages."""
    jm, js, _ = build_rung(fluid, "se_resnext50", fuse=True)
    pm, ps, _ = build_rung(pt, "se_resnext50", fuse=True)
    assert pm.to_dict() == jm.to_dict()
    assert ps.to_dict() == js.to_dict()
    types = [op.type for op in pm.global_block().ops]
    assert types.count("bn_act_conv2d") == 33
    assert types.count("bn_act_conv2d_grad") == 33


# -- one-op programs: activations, lrn, prelu, maxout, log_softmax ----------

POSITIVE = {"log", "sqrt", "rsqrt", "pow"}
ACTS = [
    ("relu", {}), ("sigmoid", {}), ("logsigmoid", {}), ("tanh", {}),
    ("tanh_shrink", {}), ("exp", {}), ("log", {}), ("sqrt", {}),
    ("rsqrt", {}), ("abs", {}), ("ceil", {}), ("floor", {}), ("round", {}),
    ("cos", {}), ("sin", {}), ("square", {}), ("reciprocal", {}),
    ("softplus", {}), ("softsign", {}), ("relu6", {"threshold": 1.5}),
    ("leaky_relu", {"alpha": 0.1}), ("elu", {"alpha": 0.7}),
    ("brelu", {"t_min": -0.5, "t_max": 1.0}), ("soft_relu", {"threshold": 1.2}),
    ("pow", {"factor": 2.5}), ("stanh", {}), ("hard_sigmoid", {}),
    ("swish", {"beta": 1.3}), ("gelu", {}), ("thresholded_relu", {}),
    ("hard_shrink", {}), ("softshrink", {"lambda": 0.3}),
    ("softmax", {"axis": 1}), ("log_softmax", {}),
]


def one_op(pkg, op_type, x, attrs, outputs=("Out",)):
    """Forward outputs and dL/dX of ``mean(sum of outputs * w)`` for one
    op on ``x`` (w a fixed random weighting, so no gradient is trivially
    uniform)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        xv = pkg.layers.data("x", shape=list(x.shape[1:]))
        xv.stop_gradient = False
        inputs = {"X": [xv]}
        block = main.global_block()
        outs = {}
        for slot in outputs:
            outs[slot] = block.create_var(
                name=pkg.unique_name.generate(slot.lower()))
        block.append_op(type=op_type, inputs=inputs,
                        outputs={k: [v] for k, v in outs.items()},
                        attrs=attrs)
        w = pkg.layers.data("w", shape=list(outs["Out"].shape[1:]))
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(outs["Out"], w))
        pkg.backward.append_backward(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    wv = rng.rand(*exe_shape(x, op_type, attrs)).astype("float32")
    fetch = [outs[s] for s in outputs] + ["x@GRAD"]
    return [np.asarray(v) for v in exe.run(
        main, feed={"x": x, "w": wv}, fetch_list=fetch, scope=scope)]


def exe_shape(x, op_type, attrs):
    if op_type == "maxout":
        return (x.shape[0], x.shape[1] // attrs["groups"]) + x.shape[2:]
    return x.shape


CASES = [(t, a, ("Out",)) for t, a in ACTS] + [
    ("lrn", {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75},
     ("Out", "MidOut")),
    ("lrn", {"n": 4, "k": 1.0, "alpha": 5e-2, "beta": 0.6},
     ("Out", "MidOut")),
    ("maxout", {"groups": 2}, ("Out",)),
]


@pytest.mark.parametrize(
    "op_type,attrs,outputs", CASES,
    ids=["%s%s" % (c[0], "_n%d" % c[1]["n"] if c[0] == "lrn" else "")
         for c in CASES])
def test_op_follows_jax(op_type, attrs, outputs):
    """Forward outputs within rtol 1e-5 (atol 1e-6), and the gradient
    through the generic ``<type>_grad`` within rtol 1e-4 (atol 1e-6), on
    a [3, 6, 5, 4] input (values 0.1..2 in magnitude, both signs except
    where the op needs positives)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.1, 2.0, (3, 6, 5, 4)).astype("float32")
    if op_type not in POSITIVE:
        x *= np.where(rng.rand(*x.shape) < 0.5, -1.0, 1.0).astype("float32")
    want = one_op(fluid, op_type, x, attrs, outputs)
    got = one_op(pt, op_type, x, attrs, outputs)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["all", "channel", "element"])
def test_prelu_follows_jax(mode):
    """``layers.prelu`` in each mode: the program, the output and the
    gradients of x and alpha (rtol 1e-5)."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 2, 2).astype("float32")
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            xv = pkg.layers.data("x", shape=[4, 2, 2])
            xv.stop_gradient = False
            out = pkg.layers.prelu(xv, mode)
            loss = pkg.layers.mean(pkg.layers.square(out))
            pkg.backward.append_backward(loss)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        alpha = main.all_parameters()[0].name
        res[pkg] = [np.asarray(v) for v in exe.run(
            main, feed={"x": x}, scope=scope,
            fetch_list=[out, "x@GRAD", alpha + "@GRAD"])]
    for g, w in zip(res[pt], res[fluid]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


# -- one training step of the models and blocks -----------------------------

def googlenet_blocks(pkg, img, class_dim, is_test=False):
    """GoogLeNet's pieces at narrow width: the 7x7 stride-2 stem and a
    ceil-mode pool, two inception blocks and another ceil-mode pool, the
    7x7 stride-7 average pool, dropout 0.4 and the softmax head."""
    g = MODS[pkg]["googlenet"]
    conv1 = g._conv(img, 8, 7, stride=2, padding=3)
    pool1 = pkg.layers.pool2d(conv1, pool_size=3, pool_stride=2,
                              pool_type="max", ceil_mode=True)
    ince_a = g.inception(pool1, 4, 4, 6, 2, 3, 3)
    ince_b = g.inception(ince_a, 6, 4, 8, 2, 4, 4)
    pool2 = pkg.layers.pool2d(ince_b, pool_size=3, pool_stride=2,
                              pool_type="max", ceil_mode=True)
    pool3 = pkg.layers.pool2d(pool2, pool_size=7, pool_stride=7,
                              pool_type="avg")
    drop = pkg.layers.dropout(pool3, dropout_prob=0.4, is_test=is_test)
    return pkg.layers.fc(drop, size=class_dim, act="softmax")


def vgg_blocks(pkg, img, class_dim, is_test=False):
    """VGG-16's pieces at narrow width: two ``img_conv_group`` blocks as
    ``vgg16_bn_drop`` builds them (2 and 3 convs with batch norm + ReLU,
    dropout 0.3 / 0.4 between, a 2x2 max pool), then dropout 0.5, fc,
    batch norm + ReLU, dropout, fc and the softmax head."""
    def block(ipt, num_filter, groups, dropouts):
        return pkg.nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv = block(block(img, 8, 2, [0.3, 0]), 16, 3, [0.4, 0.4, 0])
    drop = pkg.layers.dropout(conv, dropout_prob=0.5, is_test=is_test)
    fc1 = pkg.layers.fc(drop, size=16, act=None)
    bn = pkg.layers.batch_norm(fc1, act="relu", is_test=is_test)
    drop2 = pkg.layers.dropout(bn, dropout_prob=0.5, is_test=is_test)
    fc2 = pkg.layers.fc(drop2, size=16, act=None)
    return pkg.layers.fc(fc2, size=class_dim, act="softmax")


def se_blocks(pkg, img, class_dim, is_test=False):
    """SE-ResNeXt's pieces at narrow width: a 3x3 stem, a strided
    bottleneck (projection shortcut) and an identity one, each with its
    squeeze-excitation (cardinality 4, reduction 4), global pool, dropout
    0.5 and the softmax head."""
    se = MODS[pkg]["se"]
    conv = se.conv_bn_layer(img, 16, 3, stride=1, act="relu")
    conv = se.bottleneck_block(conv, 16, 2, 4, 4)
    conv = se.bottleneck_block(conv, 16, 1, 4, 4)
    pool = pkg.layers.pool2d(conv, pool_size=0, pool_type="avg",
                             global_pooling=True)
    drop = pkg.layers.dropout(pool, dropout_prob=0.5, is_test=is_test)
    return pkg.layers.fc(drop, size=class_dim, act="softmax")


# name: (net(pkg, img, class_dim), image size, classes, batch)
STEP_NETS = {
    "smallnet": (lambda pkg, img, cd: MODS[pkg]["smallnet"].smallnet(
        img, class_dim=cd), 32, 10, 4),
    "alexnet": (lambda pkg, img, cd: MODS[pkg]["alexnet"].alexnet(
        img, class_dim=cd), 67, 10, 2),
    "vgg_blocks": (vgg_blocks, 16, 10, 8),
    "googlenet_blocks": (googlenet_blocks, 56, 10, 4),
    "se_blocks": (se_blocks, 12, 10, 4),
}


def build_step(pkg, name):
    net, size, classes, _ = STEP_NETS[name]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.program_guard(main, startup), pkg.unique_name.guard("z_"):
        img = pkg.layers.data("img", shape=[3, size, size])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        pred = net(pkg, img, classes)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Momentum(learning_rate=1e-2,
                               momentum=0.9).minimize(loss)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    return main, startup, loss


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("name", sorted(STEP_NETS))
def test_one_step_follows_jax(name):
    """Two Momentum steps from the JAX startup state (parameters carried
    across): the losses within rtol 1e-4, every parameter gradient of
    the first step within relative L2 1e-4 plus an absolute 1e-5 on the
    distance, and every parameter after the second within rtol 1e-4 (atol
    1e-6).  The absolute term is for the bias of a conv or fc that feeds a
    batch norm, whose gradient is 0 analytically: both packages give
    rounding noise of ~1e-7 there (measured 0.9-1.4 relative L2 apart),
    while every other gradient agrees to ~3e-6."""
    jm, js, jl = build_step(fluid, name)
    pm, ps, pl = build_step(pt, name)
    assert pm.to_dict() == jm.to_dict()
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    _, size, classes, batch = STEP_NETS[name]
    rng = np.random.RandomState(0)
    grads = [p.name + "@GRAD" for p in pm.all_parameters() if p.trainable]
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for step in range(2):
        feed = {"img": rng.rand(batch, 3, size, size).astype("float32"),
                "label": rng.randint(0, classes, (batch, 1)).astype("int64")}
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


def test_bf16_rewrite_casts_a_float32_conv_input():
    """AlexNet's pattern under ``Bfloat16Transpiler``: conv -> lrn (kept
    float32) -> pool -> conv.  The JAX rewrite leaves the second conv a
    float32 input and a bfloat16 filter, which its convolution refuses
    (TypeError); the port's adds one cast to bfloat16 before it, and
    otherwise rewrites op for op as the JAX package does.  Its output
    stays within atol 0.03 of the float32 program's
    (``tests/test_torch_float16.py``'s band), argmax equal."""
    from paddle_tpu.contrib import Bfloat16Transpiler as JaxBf16

    from paddle_tpu_torch.contrib import Bfloat16Transpiler as PtBf16

    def net(pkg):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup), pkg.unique_name.guard("b_"):
            img = pkg.layers.data("img", shape=[3, 12, 12])
            c1 = pkg.layers.conv2d(img, 8, 3, padding=1, act="relu")
            n1 = pkg.layers.lrn(c1, n=5, alpha=1e-4, beta=0.75)
            p1 = pkg.layers.pool2d(n1, pool_size=3, pool_stride=2,
                                   pool_type="max")
            c2 = pkg.layers.conv2d(p1, 8, 3, padding=1, act="relu")
            pred = pkg.layers.fc(c2, size=5, act="softmax")
        return main, startup, pred

    jm, js, jp = net(fluid)
    pm, ps, pp = net(pt)
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    feed = {"img": np.random.RandomState(0).rand(4, 3, 12, 12).astype(
        "float32")}
    pexe = pt.Executor(pt.CPUPlace())
    (want,) = pexe.run(pm, feed=feed, fetch_list=[pp], scope=pscope)
    JaxBf16().transpile(jm, fluid.CPUPlace(), scope=jscope,
                        fetch_targets=[jp])
    PtBf16().transpile(pm, pt.CPUPlace(), scope=pscope, fetch_targets=[pp])
    with pytest.raises(TypeError, match="same dtypes"):
        fluid.Executor(fluid.CPUPlace()).run(jm, feed=feed,
                                             fetch_list=[jp], scope=jscope)
    jops = jm.to_dict()["blocks"][0]["ops"]
    pops = pm.to_dict()["blocks"][0]["ops"]
    # the cast, and the second conv reading it; every other op equal
    cast, conv2 = [op for op in pops if op not in jops]
    assert len(pops) == len(jops) + 1
    assert cast["type"] == "cast" and conv2["type"] == "conv2d"
    assert cast["attrs"]["out_dtype"] == "bfloat16"
    assert conv2["inputs"]["Input"] == cast["outputs"]["Out"]
    (got,) = pexe.run(pm, feed=feed, fetch_list=[pp], scope=pscope)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.03)
    assert (got.argmax(1) == want.argmax(1)).all()
