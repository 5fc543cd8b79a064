"""The port's bfloat16 inference rewrite (``contrib.float16``) against the
JAX package's: ``tests/test_float16_transpiler.py``'s three scenarios on
an artifact the JAX package trained and saved, the rewritten programs
held op for op (``Program.to_dict``), the outputs within the JAX test's
band, and rewritten artifacts crossing between the packages both ways."""

import numpy as np
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import Bfloat16Transpiler as JaxBfloat16Transpiler

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import Bfloat16Transpiler, Float16Transpiler

from test_torch_serving import fresh_torch_programs  # noqa: F401


def _build_and_train(tmp_path, seed=0):
    """The JAX test's model: fc(32, relu) -> fc(5, softmax), four Adam
    steps on clustered data, saved by the JAX package as ``m``."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(5, 16).astype("float32")
    ys = rng.randint(0, 5, 256)
    xs = (centers[ys] + 0.15 * rng.randn(256, 16)).astype("float32")
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.layers.data("x", shape=[16])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        pred = fluid.layers.fc(h, size=5, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(fluid.default_startup_program())
            for i in range(0, 256, 64):
                exe.run(feed={"x": xs[i:i + 64],
                              "label": ys[i:i + 64, None].astype("int64")},
                        fetch_list=[loss])
            fluid.io.save_inference_model(
                str(tmp_path / "m"), ["x"], [pred], exe)
    return xs, ys


def _rewrite_both(dirname, feed=None):
    """Load ``dirname`` in both packages, run each float32 program on
    ``feed`` (if given), rewrite both; returns per package (program, fetch
    vars, scope, executor, float32 output or None)."""
    out = {}
    for pkg, transpiler in ((fluid, JaxBfloat16Transpiler),
                            (pt, Bfloat16Transpiler)):
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            prog, _, fetch_vars = pkg.io.load_inference_model(dirname, exe)
            ref = None
            if feed is not None:
                (ref,) = exe.run(prog, feed=feed,
                                 fetch_list=[fetch_vars[0].name])
            transpiler().transpile(prog, pkg.CPUPlace(), scope=scope,
                                   fetch_targets=fetch_vars)
        out[pkg] = (prog, fetch_vars, scope, exe, ref)
    assert out[pt][0].to_dict() == out[fluid][0].to_dict()
    return out


def _run(pkg, prog, exe, scope, feed, fetch):
    with pkg.scope_guard(scope):
        (out,) = exe.run(prog, feed=feed, fetch_list=[fetch])
    return np.asarray(out)


def test_bf16_transpile_matches_fp32(tmp_path):
    xs, _ = _build_and_train(tmp_path)
    feed = {"x": xs[:64]}
    both = _rewrite_both(str(tmp_path / "m"), feed)
    prog, fetch_vars, scope, exe, ref = both[pt]
    # the parameters in the scope are bfloat16 now, and their vars say so
    params = prog.global_block().all_parameters()
    assert params
    for p in params:
        assert scope.find_var(p.name).dtype == torch.bfloat16, p.name
        assert p.dtype == torch.bfloat16
    # the caller still feeds and fetches float32
    out = _run(pt, prog, exe, scope, feed, fetch_vars[0].name)
    assert out.dtype == np.float32
    np.testing.assert_allclose(np.sum(out, axis=1), np.ones(64), rtol=2e-2)
    # bfloat16 keeps ~8 mantissa bits: probabilities close, argmax equal
    np.testing.assert_allclose(out, ref, atol=0.03)
    assert np.array_equal(np.argmax(out, 1), np.argmax(ref, 1))
    # and the JAX package's rewrite gives the same within that band
    jprog, jfetch, jscope, jexe, _ = both[fluid]
    want = _run(fluid, jprog, jexe, jscope, feed, jfetch[0].name)
    np.testing.assert_allclose(out, want.astype(np.float32), atol=0.03)
    assert np.array_equal(np.argmax(out, 1), np.argmax(want, 1))


def test_bf16_orphan_feed_var_not_required(tmp_path):
    """A feed var the pruned program keeps but no op reads gains no cast
    op (it would turn an optional input into a required one)."""
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.layers.data("x", shape=[4])
        fluid.layers.data("aux", shape=[4])  # never read
        pred = fluid.layers.fc(x, size=2, act="softmax")
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(fluid.default_startup_program())
            fluid.io.save_inference_model(
                str(tmp_path / "m2"), ["x", "aux"], [pred], exe)
    both = _rewrite_both(str(tmp_path / "m2"))
    prog, fetch_vars, scope, exe, _ = both[pt]
    casts = [op for op in prog.global_block().ops if op.type == "cast"]
    assert [op.inputs["X"] for op in casts][:1] == [["x"]]
    assert all(op.inputs["X"] != ["aux"] for op in casts)
    out = _run(pt, prog, exe, scope, {"x": np.zeros((3, 4), "float32")},
               fetch_vars[0].name)
    assert out.shape == (3, 2)


def test_bf16_fp32_islands_and_alias(tmp_path):
    """softmax (AMP black list) keeps float32 inputs through inserted
    casts; ``Float16Transpiler`` is the reference-named alias."""
    assert Float16Transpiler is Bfloat16Transpiler
    xs, _ = _build_and_train(tmp_path, seed=1)
    both = _rewrite_both(str(tmp_path / "m"))
    prog = both[pt][0]
    blk = prog.global_block()
    sm = [op for op in blk.ops if op.type == "softmax"]
    assert sm, "the model should contain softmax"
    for op in sm:
        for n in op.input_arg_names:
            assert blk._find_var_recursive(n).dtype == torch.float32, n
    casts = [op for op in blk.ops if op.type == "cast"]
    assert len(casts) >= 2  # the feed cast and the float32 guard at least


def test_rewritten_artifacts_cross_between_packages(tmp_path):
    """The JAX package rewrites and saves (its bfloat16 parameters land on
    disk as 2-byte raw elements); the port loads that artifact and serves
    it.  The port rewrites and saves (bfloat16 as float32); the JAX
    package loads and serves that.  Every output within the band of
    ``test_bf16_transpile_matches_fp32`` of the float32 model's."""
    xs, _ = _build_and_train(tmp_path)
    feed = {"x": xs[:64]}
    both = _rewrite_both(str(tmp_path / "m"), feed)
    ref = both[pt][4]
    for src, dst in ((fluid, pt), (pt, fluid)):
        prog, fetch_vars, scope, exe, _ = both[src]
        dirname = str(tmp_path / ("bf16_from_" + src.__name__))
        with src.scope_guard(scope):
            src.io.save_inference_model(dirname, ["x"], fetch_vars, exe,
                                        main_program=prog)
        scope2, exe2 = dst.Scope(), dst.Executor(dst.CPUPlace())
        with dst.scope_guard(scope2):
            prog2, feed_names, fetch2 = dst.io.load_inference_model(
                dirname, exe2)
            (out,) = exe2.run(prog2, feed=feed,
                              fetch_list=[fetch2[0].name])
        assert feed_names == ["x"]
        assert prog2.to_dict() == prog.clone(for_test=True).prune_feed_fetch(
            ["x"], [fetch_vars[0].name]).to_dict()
        out = np.asarray(out)
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=0.03)
        assert np.array_equal(np.argmax(out, 1), np.argmax(ref, 1))
        if dst is pt:
            for p in prog2.global_block().all_parameters():
                assert scope2.find_var(p.name).dtype == torch.bfloat16
