"""The port's pass registry, ``InferenceTranspiler``, ``memory_optimize``,
``debugger`` and ``net_drawer`` held against the JAX package on the CPU.

``list_passes()`` is the JAX registry's; ``PassBuilder`` chains passes and
feeds a returned program on; ``find_chain`` matches conv -> batch_norm;
``dead_var_eliminate`` and ``const_fold`` leave programs equal to the JAX
package's (``to_dict()``) with the same fetched results.  The BN fold of a
ResNet-18 inference program gives weights and biases bit-equal to JAX's
and an output within 1e-5; ResNet-50's 53 batch norms fold.
``memory_optimize``'s estimate, ``draw_block_graphviz``'s dot text and
``pprint_program_codes``' text equal the JAX package's."""

import os

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import debugger as j_debugger, net_drawer as j_net_drawer
from paddle_tpu.models import resnet as j_resnet

import paddle_tpu_torch as pt
from paddle_tpu_torch import debugger as p_debugger
from paddle_tpu_torch import net_drawer as p_net_drawer
from paddle_tpu_torch.convert import load_numpy_params, load_numpy_state
from paddle_tpu_torch.models import resnet as p_resnet
from paddle_tpu_torch.transpiler import passes as p_passes

from test_torch_serving import (fresh_torch_programs,  # noqa: F401
                                params_from_jax_scope)

PKGS = (fluid, pt)


def _both(build, seed=3):
    """{pkg: (main, startup, fetch)} of ``build(pkg)`` in each package."""
    out = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        out[pkg] = (main, startup, fetch)
    assert out[pt][0].to_dict() == out[fluid][0].to_dict()
    return out


def _conv_bn(pkg):
    img = pkg.layers.data("img", shape=[3, 8, 8])
    c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                          bias_attr=False)
    b = pkg.layers.batch_norm(c, act="relu", is_test=True,
                              use_global_stats=True)
    return pkg.layers.fc(b, size=2, act="softmax")


def test_registry_lists_the_jax_passes():
    assert pt.transpiler.list_passes() == fluid.transpiler.list_passes()
    assert callable(pt.transpiler.get_pass("fuse_conv_bn"))
    with pytest.raises(KeyError):
        pt.transpiler.get_pass("no_such_pass")
    with pytest.raises(KeyError):
        pt.transpiler.register_pass("fuse_conv_bn", lambda p: p)


def test_find_chain_matches_conv_bn_like_jax():
    progs = _both(_conv_bn)
    chains = {pkg: pkg.transpiler.find_chain(progs[pkg][0].global_block(),
                                             ["conv2d", "batch_norm"])
              for pkg in PKGS}
    assert chains[pt] == chains[fluid] and len(chains[pt]) == 1
    blk = progs[pt][0].global_block()
    i, j = chains[pt][0]
    assert (blk.ops[i].type, blk.ops[j].type) == ("conv2d", "batch_norm")
    # a head whose output has more than one reader does not match
    assert pt.transpiler.find_chain(blk, ["batch_norm", "conv2d"]) == []


def test_pass_builder_chains_passes_and_programs(tmp_path):
    """A custom pass, ``graph_viz`` and ``inference_optimize`` (which
    returns a new program) in one pipeline: the later passes see the new
    program, which has no batch norm left."""
    calls = []

    @pt.transpiler.register_pass("count_ops_test")
    def _count(program, tag=""):
        calls.append(tag)
        return len(program.global_block().ops)

    try:
        main, startup, pred = _both(_conv_bn)[pt]
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        n = len(main.global_block().ops)
        assert pt.transpiler.apply_pass(main, "count_ops_test",
                                        tag="direct") == n
        pb = (pt.transpiler.PassBuilder()
              .append_pass("count_ops_test", tag="before")
              .append_pass("inference_optimize", scope=scope)
              .append_pass("count_ops_test", tag="after")
              .append_pass("graph_viz", path=str(tmp_path / "g.dot")))
        pb.insert_pass(0, "dead_var_eliminate").remove_pass(0)
        assert pb.all_passes() == ["count_ops_test", "inference_optimize",
                                   "count_ops_test", "graph_viz"]
        res = pb.apply(main)
        assert calls == ["direct", "before", "after"]
        folded = res["__program__"]
        assert folded is not main and [r[0] for r in res["__history__"]] \
            == pb.all_passes()
        assert "batch_norm" not in [op.type
                                    for op in folded.global_block().ops]
        assert res["count_ops_test"] == len(folded.global_block().ops)
        assert os.path.exists(tmp_path / "g.dot")
        with pytest.raises(KeyError):
            pt.transpiler.PassBuilder().append_pass("no_such_pass")
    finally:
        p_passes._PASSES.pop("count_ops_test", None)


def _run_both(progs, feed, carry=True):
    """Fetches of each package's main program, the port's parameters
    carried across from the JAX startup state."""
    outs = {}
    for pkg in PKGS:
        main, startup, fetch = progs[pkg]
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        if pkg is fluid or not carry:
            exe.run(startup, scope=scope)
            params = params_from_jax_scope(main, scope)
        else:
            load_numpy_params(scope, params, "cpu")
        outs[pkg] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope)]
    return outs


def _dead_branch(pkg):
    a = pkg.layers.data("a", shape=[8])
    live = pkg.layers.fc(a, size=4, act="relu")
    pkg.layers.fc(a, size=32, act="relu")      # read by nothing
    return [pkg.layers.fc(live, size=2)]


@pytest.mark.parametrize("fetch_given", [True, False],
                         ids=["fetch_names", "terminal_outputs"])
def test_dead_var_eliminate_follows_jax(fetch_given):
    progs = _both(_dead_branch)
    res = {}
    for pkg in PKGS:
        main, _, fetch = progs[pkg]
        res[pkg] = pkg.transpiler.dead_var_eliminate(
            main, [fetch[0].name] if fetch_given else None)
    assert res[pt] == res[fluid]
    assert (res[pt]["ops_removed"] >= 2) == fetch_given
    assert progs[pt][0].to_dict() == progs[fluid][0].to_dict()
    feed = {"a": np.random.RandomState(0).rand(4, 8).astype("float32")}
    outs = _run_both(progs, feed)
    np.testing.assert_allclose(outs[pt][0], outs[fluid][0], rtol=1e-6)


def _constants(pkg):
    b = pkg.layers.data("b", shape=[4])
    c1 = pkg.layers.fill_constant(shape=[4], dtype="float32", value=2.0)
    c2 = pkg.layers.scale(c1, scale=0.5, bias=0.25)
    c3 = pkg.layers.elementwise_add(
        c2, pkg.layers.fill_constant(shape=[4], dtype="float32", value=1.5))
    c4 = pkg.layers.elementwise_mul(c3, c3)
    y = pkg.layers.elementwise_add(pkg.layers.fc(b, size=4), c4)
    return [y, c4]


def test_const_fold_follows_jax():
    progs = _both(_constants)
    feed = {"b": np.random.RandomState(0).rand(3, 4).astype("float32")}
    before = _run_both(progs, feed)
    folded = {pkg: pkg.transpiler.const_fold(progs[pkg][0]) for pkg in PKGS}
    assert folded[pt] == folded[fluid] >= 4
    assert progs[pt][0].to_dict() == progs[fluid][0].to_dict()
    types = [op.type for op in progs[pt][0].global_block().ops]
    assert "fill_constant" not in types and "assign_value" in types
    after = _run_both(progs, feed)
    for pkg in PKGS:
        for a, b in zip(after[pkg], before[pkg]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(after[pt], after[fluid]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # persistable outputs (a startup program's initializers) never fold
    startup = progs[pt][1]
    n = len(startup.global_block().ops)
    assert pt.transpiler.const_fold(startup) == 0
    assert len(startup.global_block().ops) == n


def test_const_fold_keeps_an_op_type_the_port_lacks():
    """``minus`` is not ported: a JAX program with a foldable ``minus``
    loaded into the port keeps it (its inputs fold), where the JAX pass
    folds it away."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.fill_constant(shape=[3], dtype="float32", value=5.)
        y = fluid.layers.fill_constant(shape=[3], dtype="float32", value=2.)
        out = main.global_block().create_var(name="diff", shape=[3],
                                             dtype="float32")
        main.global_block().append_op(type="minus",
                                      inputs={"X": [x], "Y": [y]},
                                      outputs={"Out": [out]})
        fluid.layers.scale(out, scale=2.0)
    port = pt.Program.from_dict(main.to_dict())
    assert fluid.transpiler.const_fold(main) == 4
    assert pt.transpiler.const_fold(port) == 2
    types = [op.type for op in port.global_block().ops]
    assert types == ["assign_value", "assign_value", "minus", "scale"]


def _resnet_infer(pkg, depth, size=32, class_dim=10):
    mod = j_resnet if pkg is fluid else p_resnet
    img = pkg.layers.data("img", shape=[3, size, size])
    return [mod.resnet_imagenet(img, class_dim=class_dim, depth=depth,
                                is_test=True)]


def _random_stats(program, rng):
    """Non-trivial running statistics for every batch norm."""
    stats = {}
    for op in program.global_block().ops:
        if op.type == "batch_norm":
            c = program.global_block().var(op.inputs["Mean"][0]).shape[0]
            stats[op.inputs["Mean"][0]] = (rng.randn(c) * 0.1) \
                .astype("float32")
            stats[op.inputs["Variance"][0]] = (rng.rand(c) + 0.5) \
                .astype("float32")
    return stats


def test_inference_transpiler_folds_resnet18_like_jax():
    progs = _both(lambda pkg: _resnet_infer(pkg, 18))
    jmain, jstart, jfetch = progs[fluid]
    pmain, pstart, pfetch = progs[pt]
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jstart, scope=jscope)
    rng = np.random.RandomState(0)
    stats = _random_stats(jmain, rng)
    for n, v in stats.items():
        jscope.set_var(n, v)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in jstart.list_vars() if v.persistable}
    pscope = pt.Scope()
    load_numpy_state(pscope, pstart, state, "cpu")
    feed = {"img": rng.rand(2, 3, 32, 32).astype("float32")}
    (unfolded,) = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=pfetch, scope=pscope)

    jopt = fluid.transpiler.InferenceTranspiler().transpile(
        jmain, fluid.CPUPlace(), jscope)
    popt = pt.transpiler.InferenceTranspiler().transpile(
        pmain, pt.CPUPlace(), pscope)
    assert popt.to_dict() == jopt.to_dict()
    assert "batch_norm" in [op.type for op in pmain.global_block().ops]
    types = [op.type for op in popt.global_block().ops]
    assert "batch_norm" not in types
    folded = [v.name for v in popt.list_vars() if "@BNFOLD" in v.name]
    assert len(folded) == 2 * 20
    for n in folded:
        np.testing.assert_array_equal(pscope.var(n).numpy(),
                                      np.asarray(jscope.find_var(n)),
                                      err_msg=n)
    (want,) = fluid.Executor(fluid.CPUPlace()).run(
        jopt, feed=feed, fetch_list=[jfetch[0].name], scope=jscope)
    (got,) = pt.Executor(pt.CPUPlace()).run(
        popt, feed=feed, fetch_list=[pfetch[0].name], scope=pscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, unfolded, rtol=1e-5, atol=1e-5)


def test_inference_transpiler_folds_resnet50s_53_batch_norms():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        _resnet_infer(pt, 50, size=64, class_dim=10)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    opt = pt.transpiler.InferenceTranspiler().transpile(main, scope=scope)
    types = [op.type for op in opt.global_block().ops]
    assert types.count("batch_norm") == 0
    assert types.count("elementwise_add") - [
        op.type for op in main.global_block().ops].count(
            "elementwise_add") == 53


def test_memory_optimize_estimate_equals_jax():
    progs = _both(lambda pkg: _resnet_infer(pkg, 18))
    for skip in (None, [progs[pt][2][0].name]):
        est = {pkg: pkg.transpiler.memory_optimize(progs[pkg][0],
                                                   skip_opt_set=skip)
               for pkg in PKGS}
        assert est[pt] == est[fluid] > 0
    assert pt.memory_optimize is pt.transpiler.memory_optimize
    assert pt.release_memory(progs[pt][0]) == 0


def _trained(pkg):
    x = pkg.layers.data("x", shape=[4])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    pred = pkg.layers.fc(x, size=3, act="softmax",
                         param_attr=pkg.ParamAttr(name="dbg_w"))
    loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def test_debugger_and_net_drawer_text_equals_jax(tmp_path):
    progs = _both(_trained)
    texts = {}
    for pkg, dbg, drawer in ((fluid, j_debugger, j_net_drawer),
                             (pt, p_debugger, p_net_drawer)):
        main, startup, _ = progs[pkg]
        d = tmp_path / pkg.__name__
        d.mkdir()
        path = dbg.draw_block_graphviz(main.global_block(),
                                       highlights=["dbg_w"],
                                       path=str(d / "g.dot"))
        drawer.draw_graph(startup, main, path=str(d / "n.dot"))
        texts[pkg] = [open(path).read(), open(d / "n.dot").read(),
                      open(str(d / "n.dot") + ".startup.dot").read(),
                      dbg.pprint_program_codes(main),
                      dbg.pprint_program_codes(main, show_backward=True)]
    assert texts[pt] == texts[fluid]
    dot = texts[pt][0]
    assert dot.startswith("digraph G {") and '"var_dbg_w" -> "op_' in dot
    assert "orange" in dot and not os.path.exists(
        str(tmp_path / "paddle_tpu_torch" / "g.dot.png"))
    assert "_grad" not in texts[pt][3] and "sgd" in texts[pt][4]
