"""bf16 automatic mixed precision in the port (``contrib.mixed_precision``)
held against the JAX package on the CPU.

The first cases are ``tests/test_mixed_precision.py``'s, run on the port.
Then the parity cases: a 2+2-layer Transformer (d_model 64) and two
ResNet nets, each built under ``decorate`` in both packages from the JAX
startup state, one step, every forward intermediate and every parameter
gradient fetched.  Their dtypes must be equal var for var; losses agree
within rtol 1e-2 and parameter gradients within relative L2 2e-2 at the
median.

The JAX side is compiled with ``xla_allow_excess_precision`` off.  With
it on (XLA's default) the CPU compiler drops the bfloat16 rounding of an
op's output where the next op reads it in float32, so the JAX package
computes some ops above the precision its program states: the first
attention output then differs from the port's by 2.2e-3 relative L2 on
equal inputs, ReLU masks downstream flip, and the Transformer's gradients
land 3.9e-2 apart at the median (6.6e-2 at most).  With every op's output
rounded as its dtype says, the two packages' forward passes agree to
1e-4 and the distances below hold.  The JAX side is the JAX package's
own step function (``executor.trace_program``), jitted and run once.
"""

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jax_amp
from paddle_tpu.executor import trace_program
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as amp
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import dtype_name
from paddle_tpu_torch.models import transformer as pt_transformer

from test_torch_resnet import bottleneck_net, feeds, rel_l2
from test_torch_serving import fresh_torch_programs  # noqa: F401

AMP = {fluid: jax_amp, pt: amp}
TRANSFORMER = {fluid: jax_transformer, pt: pt_transformer}


# ---------------------------------------------------------------------------
# tests/test_mixed_precision.py on the port
# ---------------------------------------------------------------------------

def test_whitelisted_matmul_computes_in_bf16():
    x = pt.layers.data("x", shape=[4])
    w = pt.layers.data("w", shape=[4, 3], append_batch_size=False)
    y = pt.layers.matmul(x, w)
    prog = pt.default_main_program()
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.random.rand(2, 4).astype("float32"),
            "w": np.random.rand(4, 3).astype("float32")}
    (out_fp32,) = exe.run(feed=feed, fetch_list=[y], return_numpy=False)
    assert out_fp32.dtype == torch.float32
    with amp.bf16_program_guard(prog):
        (out_bf16,) = exe.run(feed=feed, fetch_list=[y], return_numpy=False)
    assert out_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(out_bf16.float().numpy(), out_fp32.numpy(),
                               rtol=2e-2)


def test_blacklisted_loss_stays_fp32():
    x = pt.layers.data("x", shape=[4])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    logits = pt.layers.fc(x, size=3, act=None)
    loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, label))
    pt.optimizer.SGD(learning_rate=0.0).minimize(loss)
    prog = pt.default_main_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    with amp.bf16_program_guard(prog):
        (lv,) = exe.run(feed={"x": np.random.rand(2, 4).astype("float32"),
                              "label": np.array([[0], [1]], "int64")},
                        fetch_list=[loss], return_numpy=False)
    assert lv.dtype == torch.float32


def test_decorated_optimizer_trains_and_keeps_fp32_master_weights():
    x = pt.layers.data("x", shape=[8])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    h = pt.layers.fc(x, size=16, act="relu")
    pred = pt.layers.fc(h, size=4, act="softmax")
    loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
    amp.decorate(pt.optimizer.Adam(learning_rate=1e-2)).minimize(loss)
    main = pt.default_main_program()
    assert isinstance(main._amp_policy, amp.AMPPolicy)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    rng = np.random.RandomState(0)
    proj = rng.rand(8, 4).astype("float32")
    losses = []
    for _ in range(30):
        xv = rng.rand(32, 8).astype("float32")
        yv = (xv @ proj).argmax(1).astype("int64").reshape(-1, 1)
        (lv,) = exe.run(feed={"x": xv, "label": yv}, fetch_list=[loss])
        losses.append(float(lv.ravel()[0]))
    assert losses[-1] < losses[0] * 0.8
    # master weights and the Adam moments stay float32 in the scope
    scope = pt.global_scope()
    for v in main.list_vars():
        if v.persistable and scope.find_var(v.name) is not None:
            assert scope.var(v.name).dtype == torch.float32, v.name


def test_amp_matches_fp32_within_bf16_tolerance():
    def build():
        x = pt.layers.data("x", shape=[8])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = pt.layers.fc(x, size=4, act="softmax",
                            param_attr=pt.ParamAttr(name="w"),
                            bias_attr=pt.ParamAttr(name="b"))
        return pt.layers.mean(pt.layers.cross_entropy(pred, label))

    rng = np.random.RandomState(1)
    xv = rng.rand(16, 8).astype("float32")
    yv = rng.randint(0, 4, (16, 1)).astype("int64")
    results = {}
    for use_amp in (False, True):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 7
        with pt.program_guard(main, startup):
            loss = build()
            opt = pt.optimizer.SGD(learning_rate=0.1)
            if use_amp:
                opt = amp.decorate(opt)
            opt.minimize(loss)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        for _ in range(5):
            (lv,) = exe.run(main, feed={"x": xv, "label": yv},
                            fetch_list=[loss], scope=scope)
        results[use_amp] = float(lv.ravel()[0])
    assert results[True] == pytest.approx(results[False], rel=0.05)


def test_cast_parameters_to_bf16():
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.fc(x, size=2, act=None)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    scope = pt.global_scope()
    amp.cast_parameters_to_bf16(pt.default_main_program(), scope)
    params = pt.default_main_program().global_block().all_parameters()
    assert params
    for p in params:
        assert scope.var(p.name).dtype == torch.bfloat16
    # inference still runs: a float32 x times a bfloat16 weight promotes to
    # float32 and takes x's dtype, as jnp.matmul and the JAX mul do
    (out,) = exe.run(feed={"x": np.random.rand(2, 4).astype("float32")},
                     fetch_list=[y], return_numpy=False)
    assert out.dtype == torch.float32
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the policy and the program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("copy", ["clone", "clone_for_test", "prune"])
def test_copies_carry_the_policy_as_the_jax_package_does(copy):
    """The JAX ``clone`` and ``prune_feed_fetch`` deep-copy the program, so
    the copy holds its own ``AMPPolicy`` with the same lists; the port's
    do the same."""
    got = {}
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data("x", shape=[4])
            y = pkg.layers.fc(x, 2)
            loss = pkg.layers.mean(y)
            AMP[pkg].decorate(pkg.optimizer.SGD(0.1)).minimize(loss)
        c = {"clone": lambda: main.clone(),
             "clone_for_test": lambda: main.clone(for_test=True),
             "prune": lambda: main.prune_feed_fetch(["x"], [y.name])}[copy]()
        assert c._amp_policy is not None
        assert c._amp_policy is not main._amp_policy
        got[pkg] = (c._amp_policy.lists.white_list,
                    c._amp_policy.lists.black_list)
    assert got[pt] == got[fluid]
    assert got[pt] == (amp.AutoMixedPrecisionLists.WHITE,
                       amp.AutoMixedPrecisionLists.BLACK)


def test_policy_keys_the_entry():
    """``bf16_program_guard`` sets the policy without a version bump; the
    executor's entry key holds it, so a run under the guard analyses and
    computes anew, in bfloat16, and a run after it is back on the float32
    entry.  Policies with equal lists are equal, so the second guard (a
    policy object of its own) runs on the first guard's entry."""
    x = pt.layers.data("x", shape=[4])
    w = pt.layers.data("w", shape=[4, 3], append_batch_size=False)
    y = pt.layers.matmul(x, w)
    prog = pt.default_main_program()
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.random.rand(2, 4).astype("float32"),
            "w": np.random.rand(4, 3).astype("float32")}
    dtypes = []
    for guard in (False, True, False, True):
        version = prog._version
        if guard:
            with amp.bf16_program_guard(prog) as p:
                (out,) = exe.run(p, feed=feed, fetch_list=[y],
                                 return_numpy=False)
        else:
            (out,) = exe.run(prog, feed=feed, fetch_list=[y],
                             return_numpy=False)
        assert prog._version == version
        dtypes.append(out.dtype)
    assert dtypes == [torch.float32, torch.bfloat16] * 2
    assert prog._amp_policy is None
    policies = [k[4] for k in exe._analysis]
    assert len(policies) == 2
    assert policies[0] is None
    assert isinstance(policies[1], amp.AMPPolicy)
    assert amp.AMPPolicy() == amp.AMPPolicy()
    assert amp.AMPPolicy() != amp.AMPPolicy(amp.AutoMixedPrecisionLists(
        custom_black_list={"mul"}))


def test_policy_casts_as_the_lists_say():
    """White ops take float32 inputs to bfloat16, black ops bfloat16 to
    float32, a ``<type>_grad`` op its forward's colour, gray ops and
    integer inputs nothing; custom lists move an op between them."""
    f32 = torch.ones(2, dtype=torch.float32)
    b16 = torch.ones(2, dtype=torch.bfloat16)
    i64 = torch.ones(2, dtype=torch.int64)
    ins = {"X": [f32, b16, i64, None]}
    policy = amp.AMPPolicy()

    def dtypes(op_type, p=policy):
        return [None if v is None else v.dtype
                for v in p.cast_inputs(op_type, ins)["X"]]

    bf, fp = torch.bfloat16, torch.float32
    assert dtypes("mul") == [bf, bf, torch.int64, None]
    assert dtypes("mul_grad") == [bf, bf, torch.int64, None]
    assert dtypes("softmax") == [fp, fp, torch.int64, None]
    assert dtypes("sum") == [fp, fp, torch.int64, None]
    assert dtypes("relu") == [fp, bf, torch.int64, None]
    custom = amp.AMPPolicy(amp.AutoMixedPrecisionLists(
        custom_white_list={"relu"}, custom_black_list={"mul"}))
    assert dtypes("relu", custom) == [bf, bf, torch.int64, None]
    assert dtypes("mul", custom) == [fp, fp, torch.int64, None]


# ---------------------------------------------------------------------------
# parity with the JAX package: dtypes var for var, one step
# ---------------------------------------------------------------------------

def jax_step(program, feed, scope, fetch_names):
    """One run of ``program`` by the JAX package's step function, compiled
    with every bfloat16 output rounded (see the module docstring); returns
    the fetches as JAX arrays and writes the state back to ``scope``."""
    exe = fluid.Executor(fluid.CPUPlace())
    names = sorted(feed)
    state, writeback = exe._analyze(program, names, scope, fetch_names)
    fn, state_in, state_out = trace_program(
        program, names, state, writeback, list(fetch_names), platform="cpu")
    args = ([feed[n] for n in names],
            [np.asarray(scope.find_var(n)) for n in state_in],
            jax.random.key(0))
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    fetches, new_state = compiled(*args)
    for n, v in zip(state_out, new_state):
        scope.set_var(n, v)
    return fetches


def run_both(build, feed):
    """Build ``build(pkg)`` -> (main, startup, loss) in both packages,
    start the port from the JAX startup state, run one step of each
    fetching every non-persistable output of a forward or grad op;
    returns (names, JAX fetches, port fetches, main, loss name)."""
    jm, js, jl = build(fluid)
    pm, ps, pl = build(pt)
    assert pm.to_dict() == jm.to_dict()
    assert isinstance(pm._amp_policy, amp.AMPPolicy)
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, ps, state, "cpu")
    block = pm.global_block()
    names = []
    for op in block.ops:
        for n in op.output_arg_names:
            if n and n not in names and not block.var(n).persistable:
                names.append(n)
    want = jax_step(jm, feed, jscope, names)
    got = pt.Executor(pt.CPUPlace()).run(pm, feed=feed, fetch_list=names,
                                         scope=pscope, return_numpy=False)
    # the optimizer updated float32 master weights from the cast gradients
    for v in pm.list_vars():
        if v.persistable and v.dtype == torch.float32:
            assert pscope.var(v.name).dtype == torch.float32, v.name
    return names, want, got, pm, pl.name


def assert_dtypes_equal(names, want, got):
    """Equal dtypes var for var (the JAX package's int32 ids are the
    port's int64) and equal shapes; returns the bfloat16 var count."""
    bad = []
    for n, w, g in zip(names, want, got):
        wd, gd = str(np.dtype(w.dtype)), dtype_name(g.dtype)
        if (wd, gd) == ("int32", "int64"):
            continue
        if wd != gd or tuple(w.shape) != tuple(g.shape):
            bad.append((n, wd, gd, tuple(w.shape), tuple(g.shape)))
    assert not bad, bad
    return sum(g.dtype == torch.bfloat16 for g in got)


def step_distances(names, want, got, main, loss):
    """(loss relative error, relative L2 of each parameter gradient)."""
    vals = {n: (np.asarray(w, np.float32), g.float().numpy())
            for n, w, g in zip(names, want, got)}
    w, g = vals[loss]
    loss_err = float(abs(g[0] - w[0]) / abs(w[0]))
    grads = [rel_l2(vals[p.name + "@GRAD"][1], vals[p.name + "@GRAD"][0])
             for p in main.all_parameters()
             if p.name + "@GRAD" in vals]
    return loss_err, grads


def build_transformer(dropout):
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup), pkg.unique_name.guard("t_"):
            words = [pkg.layers.data(n, shape=[1], dtype="int64",
                                     lod_level=1)
                     for n in ("src_word", "tgt_word", "lbl_word")]
            cost, _ = TRANSFORMER[pkg].transformer(
                *words, 8, 8, 20, 20, n_layer=2, n_head=2, d_model=64,
                d_inner=128, dropout_rate=dropout)
            opt = pkg.optimizer.Adam(
                learning_rate=pkg.layers.noam_decay(64, 10), beta1=0.9,
                beta2=0.997, epsilon=1e-9)
            AMP[pkg].decorate(opt).minimize(cost)
        return main, startup, cost

    return build


def transformer_feed():
    rng = np.random.RandomState(0)
    lens = rng.randint(3, 9, 4).astype("int32")
    feed = {n: rng.randint(0, 20, (4, 8, 1)).astype("int64")
            for n in ("src_word", "tgt_word", "lbl_word")}
    feed.update({n + "@LEN": lens for n in ("src_word", "tgt_word",
                                            "lbl_word")})
    return feed


def test_transformer_amp_step_follows_jax():
    """Dropout 0: 375 fetched vars (233 of them bfloat16: the q/k/v/out
    projections, attention and its gradients, the weight gradients of
    every ``mul``) in the JAX package's dtypes; measured on the CPU the
    losses agree to 1e-7 relative and the parameter gradients within
    4.4e-3 relative L2 at the median, 9.9e-3 at most."""
    names, want, got, main, loss = run_both(build_transformer(0.0),
                                            transformer_feed())
    assert assert_dtypes_equal(names, want, got) > 200
    loss_err, grads = step_distances(names, want, got, main, loss)
    assert loss_err < 1e-2
    assert np.median(grads) <= 2e-2, sorted(grads)[-5:]


def test_transformer_amp_dtypes_follow_jax_with_dropout():
    """Dropout 0.1 adds the ``dropout`` ops (here on bfloat16 and float32
    inputs) and attention dropout; the masks come from each package's own
    generator, so only the dtypes and shapes are compared."""
    names, want, got, _, _ = run_both(build_transformer(0.1),
                                      transformer_feed())
    assert assert_dtypes_equal(names, want, got) > 200


def stem_net(pkg, bn_momentum):
    """A bfloat16 trunk into the fused layers: a 3x3 conv (white) -> BN +
    ReLU -> 1x1 -> BN + ReLU -> 1x1 -> BN + ReLU -> 3x3 -> BN, a residual
    add onto the first BN's output, global pool, fc.  64 and more channels
    at 16x16, so the JAX package runs its Pallas conv+BN kernels (in
    interpret mode) where the port runs the plain versions of #8-#11."""
    img = pkg.layers.data("img", shape=[3, 16, 16])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    c0 = pkg.layers.conv2d(img, num_filters=64, filter_size=3, padding=1,
                           bias_attr=False)
    b0 = pkg.layers.batch_norm(c0, act="relu", momentum=bn_momentum)
    c1 = pkg.layers.conv2d(b0, num_filters=128, filter_size=1,
                           bias_attr=False)
    b1 = pkg.layers.batch_norm(c1, act="relu", momentum=bn_momentum)
    c2 = pkg.layers.conv2d(b1, num_filters=64, filter_size=1,
                           bias_attr=False)
    b2 = pkg.layers.batch_norm(c2, act="relu", momentum=bn_momentum)
    c3 = pkg.layers.conv2d(b2, num_filters=64, filter_size=3, padding=1,
                           bias_attr=False)
    b3 = pkg.layers.batch_norm(c3, act=None, momentum=bn_momentum)
    res = pkg.layers.elementwise_add(x=b3, y=b0, act="relu")
    pool = pkg.layers.pool2d(res, pool_size=16, pool_type="avg",
                             global_pooling=True)
    pred = pkg.layers.fc(pool, size=5, act="softmax")
    return pkg.layers.mean(pkg.layers.cross_entropy(pred, label)), None


def build_resnet(net, mode, bn_momentum):
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup), pkg.unique_name.guard("t_"):
            loss, _ = net(pkg, bn_momentum)
            if "nhwc" in mode:
                assert pkg.transpiler.convert_to_nhwc(main) > 0
            if "fuse" in mode:
                assert pkg.transpiler.fuse_conv_bn(main) > 0
            AMP[pkg].decorate(pkg.optimizer.Momentum(
                learning_rate=0.05, momentum=0.9)).minimize(loss)
        return main, startup, loss

    return build


@pytest.mark.parametrize("mode", ["plain", "fuse", "nhwc_fuse"])
@pytest.mark.parametrize("net", ["bottleneck", "stem"])
def test_resnet_amp_step_follows_jax(net, mode):
    """One Momentum step in each of the three programs, dtypes var for var
    and the step's values.  The bottleneck net is ``test_torch_resnet``'s
    (BN momentum 0.9): its first conv is fused, so its trunk stays float32
    up to the 3x3 conv; measured, its gradients agree within 1.9e-4
    relative L2 at the median (plain) and 5.5e-7 (fused), and at most 0.21
    fused: the JAX package folds the stats cotangents with the updated
    running mean (``test_fused_gradients_fold_with_the_forward_shift``).
    The stem net puts bfloat16 into the fused layers; it runs at BN
    momentum 1.0, where that JAX fold agrees, and measures 1.84e-2 (plain)
    and 1.82e-2 (both fused programs) at the median, 2.3e-2 at most: ReLU
    signs that flip at the residual add where the two packages' bfloat16
    roundings part (their BN statistics differ by 1.5e-6 relative)."""
    if net == "bottleneck":
        build, shape, classes = build_resnet(bottleneck_net, mode, 0.9), \
            (8, 6, 6), 5
    else:
        build, shape, classes = build_resnet(stem_net, mode, 1.0), \
            (3, 16, 16), 5
    (feed,) = feeds(shape, classes, 1, seed=3)
    names, want, got, main, loss = run_both(build, feed)
    n_bf16 = assert_dtypes_equal(names, want, got)
    assert n_bf16 > (20 if net == "stem" else 4)
    loss_err, grads = step_distances(names, want, got, main, loss)
    assert loss_err < 1e-2
    assert np.median(grads) <= 2e-2, sorted(grads)[-5:]
    if net == "stem" and "fuse" in mode:
        # the fused layers took bfloat16 x and gave bfloat16 z
        fused = [op for op in main.global_block().ops
                 if op.type == "bn_act_conv2d"]
        assert fused
        for op in fused:
            i = names.index(op.outputs["Out"][0])
            assert got[i].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_policy_keys_the_captured_entry():
    """On the card: toggling ``bf16_program_guard`` between runs of one
    program gives the guarded runs their own entry, captured and replayed
    in bfloat16, and the unguarded runs keep replaying the float32 graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = pt.layers.data("x", shape=[64])
    w = pt.layers.data("w", shape=[64, 32], append_batch_size=False)
    y = pt.layers.matmul(x, w)
    prog = pt.default_main_program()
    exe = pt.Executor(pt.CUDAPlace(0))
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 64).astype("float32"),
            "w": rng.rand(64, 32).astype("float32")}
    ref = feed["x"] @ feed["w"]
    outs = {}
    for _ in range(3):      # eager, capture, replay in each colour
        for guard in (False, True):
            if guard:
                with amp.bf16_program_guard(prog):
                    (o,) = exe.run(prog, feed=feed, fetch_list=[y],
                                   return_numpy=False)
            else:
                (o,) = exe.run(prog, feed=feed, fetch_list=[y],
                               return_numpy=False)
            outs.setdefault(guard, []).append(o)
    assert [o.dtype for o in outs[False]] == [torch.float32] * 3
    assert [o.dtype for o in outs[True]] == [torch.bfloat16] * 3
    assert sum(s.graph is not None for s in exe._steps.values()) == 2
    for guard, rtol in ((False, 1e-5), (True, 2e-2)):
        for o in outs[guard]:
            np.testing.assert_allclose(o.float().cpu().numpy(), ref,
                                       rtol=rtol)
        assert torch.equal(outs[guard][1], outs[guard][2])
