"""The fused conv+BN layer's plain versions and the CNN ops of the port,
held against the JAX package on the CPU.

* ``bn_act_matmul`` / ``bn_act_matmul_nhwc`` (the plain versions of
  kernels #8-#11 under their ``torch.autograd.Function``) against the JAX
  ``custom_vjp``s of the same names, whose Pallas kernels run in interpret
  mode: the forward (z, sum, sumsq) and every cotangent, at the JAX tests'
  shapes (b=2, c=o=64, hw 512 and 9000; 9000 and the NHWC m=1300 leave a
  ragged last block);
* one-op programs (``conv2d``, ``pool2d``, ``batch_norm`` and its grad,
  ``batch_stats``, ``stats_finalize``, ``bn_apply``, ``bn_update_stats``,
  ``cross_entropy``, ``softmax``, ``mean``, ``momentum``) built in both
  packages from the JAX startup state (``run_both``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.ops.pallas import conv_bn as jax_conv_bn

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.cuda import conv_bn as pt_conv_bn

from test_torch_ops import _rand, run_both
from test_torch_serving import fresh_torch_programs  # noqa: F401

EPS = 1e-5


def _layer_inputs(rng, nhwc, n, c=64, o=64):
    """x (offset from 0, so the normalisation matters), w in the JAX API's
    layout ([O, C] NCHW, [C, O] NHWC), the BN vectors, a shift, and the
    three cotangents."""
    x = rng.randn(*((n, c) if nhwc else (2, c, n))).astype("float32") + 0.5
    w = (rng.randn(o, c) * 0.1).astype("float32")
    w = np.ascontiguousarray(w.T) if nhwc else w
    vecs = [(rng.randn(c) * 0.1).astype("float32"),
            (rng.rand(c) + 0.5).astype("float32"),
            (rng.rand(c) + 0.5).astype("float32"),
            (rng.randn(c) * 0.1).astype("float32")]
    shift = rng.randn(o).astype("float32")
    zs = (n, o) if nhwc else (2, o, n)
    cts = [rng.randn(*zs).astype("float32"),
           rng.randn(o).astype("float32"), rng.randn(o).astype("float32")]
    return [x, w] + vecs, shift, cts


CASES = [(apply_bn, act, with_stats)
         for apply_bn in (True, False) for act in ("relu", "")
         for with_stats in (True, False)]


@pytest.mark.parametrize("nhwc,n", [(False, 512), (False, 9000),
                                    (True, 1300)])
def test_bn_act_matmul_matches_jax_custom_vjp(nhwc, n):
    """Forward and all six cotangents, every (apply_bn, act, with_stats).
    Tolerance: float32 sums over up to 18,000 positions in another order,
    rtol 1e-4 with an absolute term of 1e-5 of the output's largest
    magnitude."""
    rng = np.random.RandomState(n + nhwc)
    jax_fn = jax_conv_bn.bn_act_matmul_nhwc if nhwc \
        else jax_conv_bn.bn_act_matmul
    pt_fn = pt_conv_bn.bn_act_matmul_nhwc if nhwc \
        else pt_conv_bn.bn_act_matmul
    # the large ragged case once, with everything on
    cases = CASES if n <= 1300 else [(True, "relu", True)]
    for apply_bn, act, with_stats in cases:
        args, shift, cts = _layer_inputs(rng, nhwc, n)

        def ker(*a):
            return jax_fn(*a, jnp.asarray(shift), EPS, act, apply_bn,
                          with_stats, True)

        want, vjp = jax.vjp(ker, *map(jnp.asarray, args))
        want_g = vjp(tuple(map(jnp.asarray, cts)))
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        got = pt_fn(*leaves, torch.tensor(shift), EPS, act, apply_bn,
                    with_stats)
        got_g = torch.autograd.grad(got, leaves,
                                    [torch.tensor(c) for c in cts],
                                    allow_unused=True)
        tag = "apply_bn=%s act=%r with_stats=%s" % (apply_bn, act,
                                                    with_stats)
        names = ["z", "sum", "sumsq", "dx", "dw", "dmean", "dvar", "dgamma",
                 "dbeta"]
        for name, g, w in zip(names, list(got) + list(got_g),
                              list(want) + list(want_g)):
            w = np.asarray(w)
            g = np.zeros_like(w) if g is None else g.detach().numpy()
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()) + 1e-7,
                err_msg="%s: %s" % (name, tag))


def test_bn_act_matmul_missing_stats_cotangent_skips_the_fold():
    """Only z reaches the loss: the backward gets no stats cotangent and
    must equal JAX's with zero cotangents."""
    rng = np.random.RandomState(5)
    args, shift, cts = _layer_inputs(rng, False, 300)

    def ker(*a):
        return jax_conv_bn.bn_act_matmul(*a, jnp.asarray(shift), EPS, "relu",
                                         True, True, True)

    _, vjp = jax.vjp(ker, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(cts[0]), jnp.zeros(64), jnp.zeros(64)))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    z, _, _ = pt_conv_bn.bn_act_matmul(*leaves, torch.tensor(shift), EPS,
                                       "relu", True, True)
    got = torch.autograd.grad(z, leaves, torch.tensor(cts[0]))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the op takes the plain version; the kernel wrappers
    themselves launch or raise, they never fall back."""
    x = torch.zeros(2, 8, 5)
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pt_conv_bn.conv_bn_fwd(x, w, None, None, None, None, None, "",
                               False, False)
    with pytest.raises(ValueError, match="CUDA"):
        pt_conv_bn.conv_bn_fwd_nhwc(x[0].t().contiguous(), w, None, None,
                                    None, None, None, "", False, False)
    with pytest.raises(ValueError, match="CUDA"):
        pt_conv_bn.conv_bn_bwd_nhwc(x[0].t().contiguous(), w, None,
                                    torch.zeros(5, 4), None, None, None,
                                    None, None, None, None, "", False, False)


def test_dw_splits_cover_every_position():
    for b, hw, c, o in ((128, 3136, 64, 256), (128, 49, 512, 2048),
                        (128, 196, 256, 1024), (128, 49, 2048, 512),
                        (4, 25, 64, 64), (3, 49, 72, 200), (1, 7, 8, 8)):
        n = b * hw
        # NCHW: whole images a chunk, every position in exactly one chunk,
        # about two waves of one block an SM over the (C, O) tiles
        splits, chunk = pt_conv_bn._dw_splits(b, hw, c, o)
        assert chunk % hw == 0 and splits * chunk >= n > (splits - 1) * chunk
        assert chunk >= min(256, n) or chunk == n
        covered = np.zeros(n, dtype=np.int64)
        for s in range(splits):
            covered[s * chunk:min((s + 1) * chunk, n)] += 1
        assert (covered == 1).all()
        tiles = -(-c // 128) * -(-o // 128)
        assert 1 <= splits <= 65535 and splits * tiles <= max(264, tiles)
        # the NHWC kernels: 128 x 128 (C, O) tiles, chunks a multiple of the
        # k tile (128 bytes), about two waves of one block an SM
        for dtype, step in ((torch.float32, 32), (torch.bfloat16, 64)):
            splits, chunk = pt_conv_bn._dw_splits_nhwc(n, c, o, dtype)
            assert chunk % step == 0 and chunk >= 256
            assert splits * chunk >= n > (splits - 1) * chunk
            assert 1 <= splits <= 65535 and splits * tiles <= max(264, tiles)


# ---------------------------------------------------------------------------
# one-op programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_filters=6, filter_size=3, stride=2, padding=1),
    dict(num_filters=4, filter_size=[1, 3], padding=[0, 2], dilation=2),
    dict(num_filters=6, filter_size=3, groups=2, padding=1),
    dict(num_filters=4, filter_size=1, bias_attr=False, act="relu"),
])
def test_conv2d_op(kw):
    def build(pkg):
        x = pkg.layers.data("x", shape=[4, 9, 9])
        return [pkg.layers.conv2d(x, **kw)]

    run_both(build, {"x": _rand(2, 4, 9, 9)})


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_nhwc_and_pool_through_layout_pass(fmt):
    """conv2d and pool2d after ``convert_to_nhwc``: NHWC data in the trunk,
    the boundary transposes, the same outputs."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[3, 8, 8])
        c = pkg.layers.conv2d(x, num_filters=5, filter_size=3, padding=1,
                              bias_attr=False)
        p = pkg.layers.pool2d(c, pool_size=3, pool_stride=2, pool_padding=1)
        out = pkg.layers.fc(p, size=4)
        if fmt == "NHWC":
            assert pkg.transpiler.convert_to_nhwc(
                pkg.default_main_program()) == 1
        return [out]

    run_both(build, {"x": _rand(2, 3, 8, 8)})


@pytest.mark.parametrize("ptype,kw", [
    ("max", dict(pool_size=3, pool_stride=2, pool_padding=1)),
    ("avg", dict(pool_size=3, pool_stride=2, pool_padding=1)),
    ("avg", dict(pool_size=3, pool_stride=2, pool_padding=1,
                 exclusive=False)),
    ("max", dict(pool_size=3, pool_stride=2, pool_padding=1,
                 ceil_mode=True)),
    ("avg", dict(pool_size=2, pool_stride=2, ceil_mode=True)),
    ("max", dict(pool_size=2, pool_stride=1, pool_padding=2)),
    ("avg", dict(pool_size=7, global_pooling=True)),
    ("max", dict(pool_size=7, global_pooling=True)),
])
def test_pool2d_op(ptype, kw):
    def build(pkg):
        x = pkg.layers.data("x", shape=[3, 7, 7])
        return [pkg.layers.pool2d(x, pool_type=ptype, **kw)]

    run_both(build, {"x": _rand(2, 3, 7, 7)})


@pytest.mark.parametrize("layout,momentum,two_pass", [
    ("NCHW", 0.9, False), ("NHWC", 0.9, False), ("NCHW", 0.5, True)])
def test_batch_norm_op_and_grad(layout, momentum, two_pass):
    """Train-mode batch_norm on a non-centred input: Y, the updated running
    stats, and the gradients of the conv weight (through dx), scale and
    bias, after ``append_backward``."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[4, 5, 5])
        c = pkg.layers.conv2d(x, num_filters=6, filter_size=1,
                              bias_attr=False)
        if layout == "NHWC":
            c = pkg.layers.transpose(c, perm=[0, 2, 3, 1])
        y = pkg.layers.batch_norm(c, act="relu", momentum=momentum,
                                  data_layout=layout)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(y, y))
        pkg.backward.append_backward(loss)
        block = pkg.default_main_program().global_block()
        params = [p.name for p in block.all_parameters()]
        return [y, loss] + params + [n + "@GRAD" for n in params
                                     if block.has_var(n + "@GRAD")]

    flags = [fluid, pt.flags]
    for f in flags:
        f.set_flags({"FLAGS_bn_two_pass": two_pass})
    try:
        run_both(build, {"x": _rand(3, 4, 5, 5) * 2 + 3}, rtol=2e-5,
                 atol=2e-5)
    finally:
        for f in flags:
            f.set_flags({"FLAGS_bn_two_pass": False})


def _one_op(pkg, type, inputs, outputs, attrs):
    """Append one op through a LayerHelper; returns its output vars."""
    helper = pkg.layer_helper.LayerHelper(type)
    outs = {slot: helper.create_variable_for_type_inference("float32")
            for slot in outputs}
    helper.append_op(type=type, inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()}, attrs=attrs)
    return [outs[s] for s in outputs]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_fused_stats_ops(layout):
    """batch_stats (shifted one-pass), stats_finalize (from shifted sums,
    count from an activation's shape), bn_apply (+relu) and
    bn_update_stats."""
    shape = [2, 5, 6, 6] if layout == "NCHW" else [2, 6, 6, 5]

    def build(pkg):
        x = pkg.layers.data("x", shape=shape, append_batch_size=False)
        shift, s, ss = (pkg.layers.data(n, shape=[5], append_batch_size=False)
                        for n in ("shift", "s", "ss"))
        gamma, beta = (pkg.layers.data(n, shape=[5], append_batch_size=False)
                       for n in ("gamma", "beta"))
        bm, bv = _one_op(pkg, "batch_stats", {"X": [x], "Shift": [shift]},
                         ["BatchMean", "BatchVar"], {"data_layout": layout})
        fm, fv = _one_op(pkg, "stats_finalize",
                         {"Sum": [s], "SumSq": [ss], "CountFrom": [x],
                          "Shift": [shift]}, ["BatchMean", "BatchVar"],
                         {"data_layout": layout})
        (y,) = _one_op(pkg, "bn_apply",
                       {"X": [x], "BatchMean": [bm], "BatchVar": [bv],
                        "Scale": [gamma], "Bias": [beta]}, ["Y"],
                       {"epsilon": 1e-5, "act": "relu",
                        "data_layout": layout})
        mo, vo = _one_op(pkg, "bn_update_stats",
                         {"Mean": [shift], "Variance": [gamma],
                          "BatchMean": [bm], "BatchVar": [bv]},
                         ["MeanOut", "VarianceOut"], {"momentum": 0.8})
        return [bm, bv, fm, fv, y, mo, vo]

    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(*shape).astype("float32") * 2 + 4,
            "shift": rng.randn(5).astype("float32") + 4,
            "s": rng.randn(5).astype("float32") * 10,
            "ss": rng.rand(5).astype("float32") * 100 + 50,
            "gamma": rng.rand(5).astype("float32") + 0.5,
            "beta": rng.randn(5).astype("float32")}
    run_both(build, feed, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_cross_entropy_mean(soft):
    def build(pkg):
        x = pkg.layers.data("x", shape=[7])
        p = pkg.layers.softmax(pkg.layers.fc(x, size=5))
        if soft:
            lbl = pkg.layers.data("lbl", shape=[5])
        else:
            lbl = pkg.layers.data("lbl", shape=[1], dtype="int64")
        ce = pkg.layers.cross_entropy(p, lbl, soft_label=soft)
        return [p, ce, pkg.layers.mean(ce)]

    rng = np.random.RandomState(4)
    lbl = (rng.dirichlet(np.ones(5), 6).astype("float32") if soft
           else rng.randint(0, 5, (6, 1)).astype("int64"))
    run_both(build, {"x": _rand(6, 7), "lbl": lbl})


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_op(nesterov):
    """One Momentum step of an fc net: the loss, and every persistable
    value after the step (parameters and velocities, updated in place)."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[6])
        lbl = pkg.layers.data("lbl", shape=[1], dtype="int64")
        p = pkg.layers.fc(x, size=4, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(p, lbl))
        pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                               use_nesterov=nesterov).minimize(loss)
        block = pkg.default_main_program().global_block()
        return [loss] + [v for v in block.vars.values() if v.persistable]

    rng = np.random.RandomState(6)
    feed = {"x": rng.randn(5, 6).astype("float32"),
            "lbl": rng.randint(0, 4, (5, 1)).astype("int64")}
    # a nonzero starting velocity, so mu * v enters the update
    main = pt.Program()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard("t_"):
        build(pt)
    state = {v.name: rng.randn(*v.shape).astype("float32")
             for v in main.list_vars() if "velocity" in v.name}
    assert len(state) == 2
    # run_both carries the parameters; the learning rate rides along here
    state.update({v.name: np.full(v.shape, 0.1, "float32")
                  for v in main.list_vars() if "learning_rate" in v.name})
    run_both(build, feed, state=state)
