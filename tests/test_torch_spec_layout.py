"""Named-mesh model parallelism in the port (``tests/test_spec_layout.py``'s
cases): the ``SpecLayout`` table and rules, the parameter classes, the
graceful degradation of ``resolve`` — every spec equal to the JAX
package's, in this process and with no world — then, in a world of 4
gloo ranks (``torch_mesh_world``), ``sharding_rules`` through the
``ParallelExecutor``: the fsdp Transformer's losses against the JAX
``ParallelExecutor`` at the same mesh shape (dropout 0) and against the
port's single-device run (dropout 0.1), the state at rest about 1/N a
rank, the hook's precedence over the table, and TrainState round trips
between a mesh and one device.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_world import error_of, run_world  # noqa: E402

WORLD = 4


def _build_transformer(pkg, seed=11, t=8, vocab=32, dropout=0.1,
                       n_layer=1):
    if pkg.__name__ == "paddle_tpu":
        from paddle_tpu.models import transformer as tfm
    else:
        from paddle_tpu_torch.models import transformer as tfm
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    words = [pkg.layers.data(n, shape=[1], dtype="int64", lod_level=1)
             for n in ("src_word", "tgt_word", "lbl_word")]
    cost, _ = tfm.transformer(*words, t, t, vocab, vocab, n_layer=n_layer,
                              n_head=2, d_model=16, d_inner=32,
                              dropout_rate=dropout)
    pkg.optimizer.Adam(learning_rate=2e-3).minimize(cost)
    return cost


def _batches(steps=3, batch=8, t=8, vocab=32):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        ids = rng.randint(2, vocab, (batch, t, 1)).astype("int64")
        lens = rng.randint(t // 2, t + 1, (batch,)).astype("int32")
        out.append({"src_word": ids, "src_word@LEN": lens,
                    "tgt_word": ids, "tgt_word@LEN": lens,
                    "lbl_word": ids, "lbl_word@LEN": lens})
    return out


def _build_mlp(pkg, seed=7):
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    x = pkg.layers.data("x", shape=[16])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(x, size=32, act="relu")
    pred = pkg.layers.fc(h, size=4, act=None)
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(pred, label))
    pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return loss


def _mlp_feeds(steps=2, first=0):
    out = []
    for i in range(first, first + steps):
        x = np.random.RandomState(i).rand(8, 16).astype("float32")
        out.append({"x": x, "label": x[:, :4].argmax(1).astype("int64")
                    .reshape(-1, 1)})
    return out


def _state_in(inputs):
    return {k[2:]: v for k, v in inputs.items() if k.startswith("S:")}


def _start(pt, inputs):
    from paddle_tpu_torch.convert import load_numpy_state

    load_numpy_state(pt.global_scope(), pt.default_startup_program(),
                     _state_in(inputs), "cpu")


def _rules(pt, kreduce=False, fn=None):
    bs = pt.BuildStrategy()
    bs.sharding_rules = True
    if kreduce:
        bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
    bs.param_sharding_fn = fn
    return bs


def _losses(pe, loss, feeds):
    return np.array([float(np.asarray(pe.run([loss], feed=f)[0]).ravel()[0])
                     for f in feeds])


# ---------------------------------------------------------------------------
# the ranks' cases
# ---------------------------------------------------------------------------

def case_rules_kreduce(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             mesh=pt.make_mesh((world,)),
                             build_strategy=_rules(pt, kreduce=True))
    f = _mlp_feeds(1)[0]
    pe.run([loss], feed={"x": f["x"], "label": np.zeros((8, 1), "int64")})
    return {"shape": np.array(pt.global_scope().var("fc_0.w_0").shape),
            "spec": np.array(str(pe.state_shardings()["fc_0.w_0"].spec))}


def _fsdp_case(inputs, world, dropout):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import spec_layout as sl

    cost = _build_transformer(pt, dropout=dropout)
    _start(pt, inputs)
    pe = pt.ParallelExecutor(
        use_cuda=False, loss_name=cost.name,
        mesh=pt.make_mesh((1, 2, 2), ("dp", "fsdp", "tp")),
        build_strategy=_rules(pt))
    out = {"losses": _losses(pe, cost, _batches())}
    sh = pe.state_shardings()
    moment = next(n for n in sl.optimizer_slot_params(
        pt.default_main_program()) if "src_word_emb_moment1" in n)
    out["specs"] = np.array([str(sh[n].spec) for n in (
        "src_word_emb", "enc0_attn_q.w_0", moment)])
    out["emb_shape"] = np.array(pt.global_scope().var("src_word_emb").shape)
    return out


def case_fsdp_nodrop(inputs, rank, world):
    return _fsdp_case(inputs, world, 0.0)


def case_fsdp_dropout(inputs, rank, world):
    return _fsdp_case(inputs, world, 0.1)


def case_fsdp_bytes(inputs, rank, world):
    """The state each rank holds at rest, replicated and fsdp-sharded."""
    import paddle_tpu_torch as pt

    cost = _build_transformer(pt)
    _start(pt, inputs)
    out = {}
    for label, mesh, bs in (
            ("replicated", pt.make_mesh((world,)), None),
            ("fsdp", pt.make_mesh((1, world), ("dp", "fsdp")), _rules(pt))):
        scope = pt.Scope()
        from paddle_tpu_torch.convert import load_numpy_state

        load_numpy_state(scope, pt.default_startup_program(),
                         _state_in(inputs), "cpu")
        pe = pt.ParallelExecutor(use_cuda=False, loss_name=cost.name,
                                 mesh=mesh, build_strategy=bs, scope=scope)
        pe.run([cost], feed=_batches(1)[0])
        out[label] = np.array(sum(
            scope.var(n).numel() * scope.var(n).element_size()
            for n in scope.local_var_names()))
    return out


def case_fn_overrides_rules(inputs, rank, world):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import PartitionSpec as P

    cost = _build_transformer(pt)
    _start(pt, inputs)
    pe = pt.ParallelExecutor(
        use_cuda=False, loss_name=cost.name,
        mesh=pt.make_mesh((1, world), ("dp", "fsdp")),
        build_strategy=_rules(pt, fn=lambda name, shape: (
            P() if name == "src_word_emb" else None)))
    pe.run([cost], feed=_batches(1)[0])
    sh = pe.state_shardings()
    return {"specs": np.array([str(sh[n].spec) for n in (
        "src_word_emb", "enc0_attn_q.w_0")]),
        "emb_shape": np.array(pt.global_scope().var("src_word_emb").shape)}


def case_save_on_mesh(inputs, rank, world):
    """Train on a (dp 2, fsdp 2) mesh, capture (gathered whole), save from
    rank 0."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.checkpoint import (capture_train_state,
                                                      save_train_state)

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             mesh=pt.make_mesh((2, 2), ("dp", "fsdp")),
                             build_strategy=_rules(pt))
    _losses(pe, loss, _mlp_feeds(2))
    scope = pt.global_scope()
    local = np.array(scope.var("fc_0.w_0").shape)
    ts = capture_train_state(2, scope=scope, executors=pe)
    if rank == 0:
        save_train_state(str(inputs["dir"]), ts)
    out = {"local": local,
           "spec": np.array(str(pe.state_shardings()["fc_0.w_0"].spec))}
    out.update({"S:" + n: v.numpy() for n, v in ts.arrays.items()})
    return out


def case_restore_onto_mesh(inputs, rank, world):
    """Restore a single-device artifact onto a (dp 2, fsdp 2) mesh with the
    executor's shardings, and train on."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.checkpoint import (apply_train_state,
                                                      load_train_state)

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             mesh=pt.make_mesh((2, 2), ("dp", "fsdp")),
                             build_strategy=_rules(pt))
    scope = pt.global_scope()
    ts = load_train_state(str(inputs["dir"]))
    sh = pe.state_shardings()
    apply_train_state(ts, scope=scope, executors=pe, shardings=sh)
    out = {"local": np.array(scope.var("fc_0.w_0").shape)}
    out["equal"] = np.array(all(
        np.array_equal(scope.var(n).numpy(), sh[n].shard(v).numpy())
        for n, v in ts.arrays.items()))
    out["loss"] = np.asarray(pe.run([loss], feed={
        "x": np.random.RandomState(9).rand(8, 16).astype("float32"),
        "label": np.zeros((8, 1), "int64")})[0])
    return out


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# in-process: the table, the classes and resolve against the JAX package
# ---------------------------------------------------------------------------

def _both_programs(build):
    """The same program built in both packages, fresh name counters."""
    import paddle_tpu as fluid
    import paddle_tpu_torch as pt
    from paddle_tpu import unique_name

    out = []
    for pkg, guard in ((fluid, unique_name.guard), (pt, pt.unique_name.guard)):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), guard():
            build(pkg)
        out.append(main)
    return out


def _norm(spec):
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in entries)


def test_spec_layout_canonical_table():
    from paddle_tpu_torch.parallel import PartitionSpec as P, SpecLayout

    lay = SpecLayout()
    assert lay.embeddings() == P(("fsdp", "tp"), None)
    assert lay.qkv_projection() == P("fsdp", "tp")
    assert lay.attn_output() == P("tp", "fsdp")
    assert lay.ffn_up() == P("fsdp", "tp")
    assert lay.ffn_down() == P("tp", "fsdp")
    assert lay.norm_scale() == P("fsdp")
    assert lay.batch() == P(("dp", "fsdp"))


def test_spec_layout_axis_renaming():
    from paddle_tpu_torch.parallel import PartitionSpec as P, SpecLayout

    lay = SpecLayout(fsdp_axis="dp")
    assert lay.embeddings() == P(("dp", "tp"), None)
    assert dict(lay.rules)["embed"] == "dp"


def test_classify_transformer_params():
    """The port's classes are the JAX package's, var for var."""
    from paddle_tpu.parallel import spec_layout as jsl
    from paddle_tpu_torch.parallel import spec_layout as sl

    jm, tm = _both_programs(lambda p: _build_transformer(p, n_layer=2))
    classes = sl.classify_params(tm)
    assert classes == jsl.classify_params(jm)
    assert classes["src_word_emb"] == ("vocab", "embed")
    assert classes["enc0_attn_q.w_0"] == ("embed", "mlp")
    assert classes["enc0_attn_o.w_0"] == ("mlp", "embed")
    assert classes["enc0_ffn_fc1.w_0"] == ("embed", "mlp")
    assert classes["enc0_ffn_fc2.w_0"] == ("mlp", "embed")
    assert len([n for n, c in classes.items() if c == ("norm",)]) >= 8


def test_optimizer_slots_inherit_param_class():
    from paddle_tpu.parallel import spec_layout as jsl
    from paddle_tpu_torch.parallel import spec_layout as sl

    jm, tm = _both_programs(_build_transformer)
    slots = sl.optimizer_slot_params(tm)
    assert slots == jsl.optimizer_slot_params(jm)
    moments = {s: p for s, p in slots.items() if "_moment" in s}
    assert moments
    assert all(s.startswith(p) for s, p in moments.items())
    assert any(p == "src_word_emb" for p in moments.values())


@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("dp", "fsdp")), ((1, 2, 2), ("dp", "fsdp", "tp")),
    ((2, 1, 1), ("dp", "fsdp", "tp")), ((1, 4, 2), ("dp", "fsdp", "tp")),
    ((8,), ("dp",)), ((2, 4), ("dp", "tp"))])
def test_resolve_tables_equal_the_jax_package(shape, axes):
    """``SpecLayout.resolve`` over every persistable var of the
    Transformer's train program (its shapes, and a few off-size ones that
    shed axes): the port's specs are the JAX package's exactly.  No world:
    the port's mesh is a description."""
    from paddle_tpu.parallel import SpecLayout as JSpecLayout
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh

    jm, tm = _both_programs(lambda p: _build_transformer(p, n_layer=2))
    names = [(v.name, tuple(v.shape)) for v in tm.list_vars()
             if v.persistable and v.shape]
    names += [("src_word_emb", (6, 16)), ("src_word_emb", (7, 16)),
              ("learning_rate_0", (1,)), ("some_counter", (8, 3))]
    want = JSpecLayout().resolve(jm, jmake_mesh(shape, axes), names)
    got = SpecLayout().resolve(tm, make_mesh(shape, axes), names)
    assert {n: _norm(s) for n, s in got.items()} == \
        {n: _norm(s) for n, s in want.items()}


def test_resolve_degrades_gracefully():
    from paddle_tpu_torch.parallel import (PartitionSpec as P, SpecLayout,
                                           make_mesh)

    _, program = _both_programs(_build_transformer)
    lay = SpecLayout()
    specs = lay.resolve(program, make_mesh((2, 2), ("dp", "fsdp")),
                        [("src_word_emb", (64, 16)),
                         ("enc0_attn_q.w_0", (16, 16))])
    assert specs["src_word_emb"] == P("fsdp")
    assert specs["enc0_attn_q.w_0"] == P("fsdp")
    mesh3 = make_mesh((1, 2, 2), ("dp", "fsdp", "tp"))
    specs3 = lay.resolve(program, mesh3, [("src_word_emb", (64, 16)),
                                          ("enc0_attn_q.w_0", (16, 16)),
                                          ("enc0_attn_o.w_0", (16, 16))])
    assert specs3["src_word_emb"] == P(("fsdp", "tp"))
    assert specs3["enc0_attn_q.w_0"] == P("fsdp", "tp")
    assert specs3["enc0_attn_o.w_0"] == P("tp", "fsdp")
    assert lay.resolve(program, mesh3, [("src_word_emb", (6, 16))])[
        "src_word_emb"] == P("fsdp")
    assert lay.resolve(program, mesh3, [("src_word_emb", (7, 16))])[
        "src_word_emb"] == P(None, "fsdp")
    misc = lay.resolve(program, mesh3, [("learning_rate_0", (1,)),
                                        ("some_counter", (8, 3))])
    assert misc["learning_rate_0"] == P()
    assert misc["some_counter"] == P("fsdp")


def test_spec_layout_value_equality():
    from paddle_tpu_torch.parallel import SpecLayout

    assert SpecLayout() == SpecLayout()
    assert hash(SpecLayout()) == hash(SpecLayout())
    assert SpecLayout() != SpecLayout(fsdp_axis="dp")


def test_axis_size_one_drops_out():
    from paddle_tpu_torch.parallel import (PartitionSpec as P, SpecLayout,
                                           make_mesh)

    _, program = _both_programs(_build_transformer)
    specs = SpecLayout().resolve(
        program, make_mesh((2, 1, 1), ("dp", "fsdp", "tp")),
        [("src_word_emb", (64, 16))])
    assert specs["src_word_emb"] == P()


def test_device_gauges_emit_stats_and_report_columns(tmp_path, monkeypatch):
    """``monitor.sample_device_gauges`` (the ``ParallelExecutor`` samples
    its rank's device every step) publishes the per-device gauges and the
    decimated ``device_stats`` JSONL event that ``tools/program_report``
    folds into its per-device table."""
    import torch

    from paddle_tpu_torch import monitor

    stats = {"cuda0": {"bytes_in_use": 100, "bytes_limit": 1 << 30},
             "cuda1": {"bytes_in_use": 400, "bytes_limit": 1 << 30}}
    monkeypatch.setattr(monitor, "_device_state",
                        lambda d: dict(stats["%s%d" % (d.type, d.index)]))
    monitor.enable(log_dir=str(tmp_path))
    try:
        devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
        monitor.sample_device_gauges(devs)
        stats["cuda1"]["bytes_in_use"] = 900
        for _ in range(10):
            monitor.sample_device_gauges(devs)
        reg = monitor.registry()
        assert reg.gauge("device/cuda1/bytes_in_use_peak").value == 900
        assert reg.gauge("device/cuda0/bytes_in_use_peak").value == 100
    finally:
        monitor.disable()
        monitor.registry().reset()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import program_report

    devices = program_report.devices_from_records(
        program_report.load_records(str(tmp_path)))
    assert devices["cuda0"]["bytes_in_use_peak"] == 100
    assert devices["cuda1"]["bytes_in_use_peak"] == 900
    assert "min 100 B / max 900 B" in program_report.render_device_table(
        devices)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _jax_state(build):
    import paddle_tpu as fluid
    from paddle_tpu import unique_name

    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start), unique_name.guard():
        build(fluid)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(start, scope=scope)
    return {"S:" + v.name: np.array(scope.find_var(v.name), copy=True)
            for v in start.list_vars() if v.persistable}


def _port_single(build, state, feeds):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import load_numpy_state

    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        loss = build(pt)
    scope = pt.Scope()
    load_numpy_state(scope, start, _state_in(state), "cpu")
    exe = pt.Executor(pt.CPUPlace())
    losses = np.array([float(np.asarray(exe.run(
        main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0])
        for f in feeds])
    return losses, scope, exe, (main, start)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spec_world")
    mlp = _jax_state(_build_mlp)
    tfm0 = _jax_state(lambda f: _build_transformer(f, dropout=0.0))
    tfm1 = _jax_state(_build_transformer)
    # the single-device artifact the mesh restores
    from paddle_tpu_torch.parallel.checkpoint import (capture_train_state,
                                                      save_train_state)

    _, scope, exe, (main, _s) = _port_single(_build_mlp, mlp, _mlp_feeds(2))
    solo_dir = str(tmp / "solo_ck")
    save_train_state(solo_dir, capture_train_state(2, scope=scope,
                                                   program=main,
                                                   executors=exe))
    solo = {n: scope.var(n).numpy().copy() for n in scope.local_var_names()}
    inputs = {
        "rules_kreduce": mlp, "fsdp_nodrop": tfm0, "fsdp_dropout": tfm1,
        "fsdp_bytes": tfm1, "fn_overrides_rules": tfm1,
        "save_on_mesh": dict(mlp, dir=np.array(str(tmp / "mesh_ck"))),
        "restore_onto_mesh": dict(mlp, dir=np.array(solo_dir)),
    }
    res = run_world(os.path.abspath(__file__), WORLD, sorted(CASES), tmp,
                    inputs)
    return res, inputs, solo, str(tmp / "mesh_ck")


def _one(world, case):
    res = world[0][case]
    for r in res:
        assert not error_of(r), r.get("__trace__")
    return res[0]


def test_rules_do_not_shadow_kreduce_on_pure_dp_mesh(world):
    """``sharding_rules`` on a mesh with no populated fsdp/tp axis resolves
    every var replicated and falls through to kReduce's ZeRO dim 0 over
    dp: [16, 32] held as [4, 32] a rank."""
    for r in world[0]["rules_kreduce"]:
        assert not error_of(r), r.get("__trace__")
        assert r["shape"].tolist() == [4, 32]
        assert str(r["spec"]) == "PartitionSpec('dp',)"


def test_fsdp_transformer_loss_parity_and_state_sharding(world):
    import paddle_tpu as fluid
    from paddle_tpu.parallel import make_mesh

    r = _one(world, "fsdp_nodrop")
    cost = _build_transformer(fluid, dropout=0.0)
    fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
    bs = fluid.BuildStrategy()
    bs.sharding_rules = True
    pe = fluid.ParallelExecutor(
        loss_name=cost.name, build_strategy=bs,
        mesh=make_mesh((1, 2, 2), ("dp", "fsdp", "tp")))
    want = [float(np.asarray(pe.run(feed=f, fetch_list=[cost])[0])
                  .ravel()[0]) for f in _batches()]
    np.testing.assert_allclose(r["losses"], want, rtol=1e-4, atol=1e-4)
    single = _port_single(lambda p: _build_transformer(p, dropout=0.0),
                          world[1]["fsdp_nodrop"], _batches())[0]
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4, atol=1e-4)
    assert r["specs"].tolist() == [
        "PartitionSpec(('fsdp', 'tp'),)", "PartitionSpec('fsdp', 'tp')",
        "PartitionSpec(('fsdp', 'tp'),)"]
    # the [32, 16] table held as [8, 16] a rank
    assert r["emb_shape"].tolist() == [8, 16]


def test_fsdp_transformer_with_dropout_equals_single_device(world):
    r = _one(world, "fsdp_dropout")
    single = _port_single(_build_transformer, world[1]["fsdp_dropout"],
                          _batches())[0]
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4, atol=1e-4)
    assert r["losses"][-1] < r["losses"][0]


def test_fsdp_per_device_state_drops_one_over_n(world):
    """The state a rank holds at rest under fsdp over 4 ranks: about a
    quarter of the replicated run's (scalar counters stay whole)."""
    for r in world[0]["fsdp_bytes"]:
        assert not error_of(r), r.get("__trace__")
        share = float(r["fsdp"]) / float(r["replicated"])
        assert 0.2 < share < 0.35, share


def test_param_sharding_fn_overrides_rules(world):
    r = _one(world, "fn_overrides_rules")
    assert r["specs"].tolist() == ["PartitionSpec()",
                                   "PartitionSpec('fsdp',)"]
    assert r["emb_shape"].tolist() == [32, 16]


def test_train_state_fsdp_save_restores_single_device(world):
    """Saved from a (dp 2, fsdp 2) mesh (gathered whole, rank 0 writing),
    restored on one device: bit-identical to the mesh's state."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.checkpoint import (apply_train_state,
                                                      load_train_state)

    r = _one(world, "save_on_mesh")
    assert str(r["spec"]) == "PartitionSpec('fsdp',)"
    assert r["local"].tolist() == [8, 32]
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        _build_mlp(pt)
    solo = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(start, scope=solo)
    apply_train_state(load_train_state(world[3]), scope=solo, program=main,
                      executors=pt.Executor(pt.CPUPlace()))
    for k, v in r.items():
        if k.startswith("S:"):
            np.testing.assert_array_equal(solo.var(k[2:]).numpy(), v,
                                          err_msg=k)


def test_train_state_single_device_save_restores_onto_mesh(world):
    for r in world[0]["restore_onto_mesh"]:
        assert not error_of(r), r.get("__trace__")
        assert r["local"].tolist() == [8, 32]
        assert bool(r["equal"])
        assert np.isfinite(r["loss"]).all()


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
