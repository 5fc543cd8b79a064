"""Distributed training in the port (``tests/test_dist_train.py``'s
cases): a world of 2 gloo ranks (``torch_mesh_world``) runs
``tests/dist_model.py``'s workloads the way ``tests/dist_runner.py`` does
— the ``DistributeTranspiler``'s plan over ``make_mesh()``, each rank
feeding its local half of every global batch — and each rank's losses
must equal the single-device run's (the JAX package's, from the same
startup state, and the port's own); then the transpiler's plan against
the shardings the executor really holds, the plan and accounting in this
process, the preemption vote, ``Trainer(parallel=True)`` in the world
(with sharded checkpoints, a signal on one rank and a resume), and the
kill-and-resume drill: SIGTERM on both ranks, a flush step agreed
by the vote and saved by ``ShardedCheckpointManager.save_now``, and
fresh ranks that resume from it.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dist_model  # noqa: E402
from torch_mesh_world import (error_of, finish_world,  # noqa: E402
                              run_world, start_world)

WORLD = 2
WORKLOADS = ("mlp", "sparse", "text_cls", "word2vec")


def _state_in(inputs):
    return {k[2:]: v for k, v in inputs.items() if k.startswith("S:")}


def _dist_case(workload):
    def case(inputs, rank, world):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.convert import load_numpy_state

        build_fn, batches_fn = dist_model.MODELS[workload]
        loss = build_fn(pt)
        load_numpy_state(pt.global_scope(), pt.default_startup_program(),
                         _state_in(inputs), "cpu")
        t = pt.DistributeTranspiler()
        t.transpile(trainer_id=rank, trainers=world)
        mesh = pt.make_mesh()
        pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 build_strategy=t.build_strategy(mesh),
                                 mesh=mesh)
        lo = rank * (dist_model.BATCH // world)
        hi = lo + dist_model.BATCH // world
        losses = [float(np.asarray(pe.run(
            [loss], feed={k: v[lo:hi] for k, v in f.items()},
            local_feed=True)[0]).ravel()[0]) for f in batches_fn()]
        return {"losses": np.array(losses)}
    return case


def case_plan_shardings(inputs, rank, world):
    """``test_transpiler_plan_matches_compiled_shardings``: what the plan
    says against what each rank holds."""
    import paddle_tpu_torch as pt

    ids = pt.layers.data("ids", shape=[4, 1], dtype="int64")
    emb = pt.layers.embedding(ids, size=[64, 16], is_distributed=True,
                              param_attr=pt.ParamAttr(name="table_w"))
    big = pt.layers.fc(pt.layers.reduce_mean(emb, dim=1), size=1024,
                       param_attr=pt.ParamAttr(name="big_w"),
                       bias_attr=pt.ParamAttr(name="small_b"))
    loss = pt.layers.mean(big)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    t = pt.DistributeTranspiler()
    t.transpile(trainer_id=0, trainers=1)
    mesh = pt.make_mesh((1, 2), ("dp", "ep"))
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                             build_strategy=t.build_strategy(mesh))
    (lv,) = pe.run([loss], feed={"ids": np.random.RandomState(0).randint(
        0, 64, (8, 4, 1)).astype("int64")})
    scope = pt.global_scope()
    sh = pe.state_shardings()
    names = sorted(n for n in scope.local_var_names()
                   if n.startswith(("table_w", "big_w", "small_b"))
                   and "pow" not in n)
    return {"names": np.array(names),
            "specs": np.array([str(sh[n].spec) for n in names]),
            "shapes": np.array([list(scope.var(n).shape) + [0] * (
                2 - scope.var(n).dim()) for n in names]),
            "loss": np.asarray(lv)}


def case_vote(inputs, rank, world):
    """The preemption vote: one flagged rank flags every rank."""
    from paddle_tpu_torch.parallel import distributed

    return {"none": np.array(distributed.any_process_flagged(False)),
            "one": np.array(distributed.any_process_flagged(rank == 1)),
            "count": np.array(distributed.process_count()),
            "id": np.array(distributed.process_id())}


def _trainer_func():
    import paddle_tpu_torch as pt

    pt.default_main_program().random_seed = 3
    pt.default_startup_program().random_seed = 3
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.data("y", shape=[1])
    h = pt.layers.fc(x, size=8, act="relu")
    return pt.layers.mean(pt.layers.square_error_cost(
        pt.layers.fc(h, size=1), y))


def _trainer_rows():
    rng = np.random.RandomState(0)
    return [(rng.rand(4).astype("float32"),
             rng.rand(1).astype("float32")) for _ in range(64)]


def _trainer_losses(on_step=None, **kw):
    """Two epochs of the Trainer over ``_trainer_rows`` (a checkpointable
    reader); ``on_step(n)`` after the n-th step of this run."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import EndStepEvent, Trainer
    from paddle_tpu_torch.reader import checkpointable

    rows = _trainer_rows()
    got = []

    def handler(ev):
        if isinstance(ev, EndStepEvent):
            got.append(float(np.asarray(ev.metrics[0]).ravel()[0]))
            if on_step is not None:
                on_step(len(got))

    t = Trainer(_trainer_func, lambda: pt.optimizer.SGD(0.3),
                place=pt.CPUPlace(), **kw)
    t.train(2, handler, reader=checkpointable(pt.batch(lambda: iter(rows),
                                                       16)),
            feed_order=["x", "y"])
    return np.array(got)


def case_trainer(inputs, rank, world):
    return {"losses": _trainer_losses(parallel=True)}


FLUSH_STEP = 3


def case_trainer_flush(inputs, rank, world):
    """``Trainer(parallel=True)`` with an async sharded checkpoint every
    step: rank 1 is signalled after step ``FLUSH_STEP``, both ranks stop
    there and flush the step the periodic save is writing.  The saver's
    commit is held back 0.5 s, so the non-saver's flush comes while the
    commit is still to land.  Returns each step's shard writes on this
    rank."""
    import signal
    import time

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.contrib import CheckpointConfig

    writes = []
    every = fault.FaultSchedule(every=1)
    fault.register("checkpoint/before_write",
                   lambda step, **_: writes.append(step), every)
    if rank == 0:
        fault.register("checkpoint/before_commit",
                       lambda step, **_: time.sleep(0.5), every)
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        losses = _trainer_losses(
            lambda n: rank == 1 and n == FLUSH_STEP and os.kill(
                os.getpid(), signal.SIGTERM),
            parallel=True, checkpoint_config=CheckpointConfig(
                checkpoint_dir=str(inputs["ckpt"]), step_interval=1))
    finally:
        signal.signal(signal.SIGTERM, prev)
        fault.clear()
    out = {"losses": losses, "writes": np.array(writes),
           "signals": np.array(len(got))}
    if rank == 0:
        # the saver returns once its commits landed, the peer's included
        ckpt = str(inputs["ckpt"])
        out["entries"] = np.array(sorted(os.listdir(ckpt)))
        with open(os.path.join(ckpt, "step_%010d" % FLUSH_STEP,
                               "MANIFEST.json")) as f:
            out["manifest"] = np.array(f.read())
    return out


def case_trainer_resume(inputs, rank, world):
    """A fresh Trainer in the world over ``trainer_flush``'s directory:
    it resumes at the flushed step and trains to the end."""
    from paddle_tpu_torch.contrib import CheckpointConfig

    cfg = CheckpointConfig(checkpoint_dir=str(inputs["ckpt"]),
                           step_interval=1)
    losses = _trainer_losses(parallel=True, checkpoint_config=cfg)
    return {"losses": losses, "load_serial": np.array(cfg.load_serial)}


def case_preempt(inputs, rank, world):
    """``tests/dist_runner.py``'s preemption-aware run of the ``mlp``
    workload: resume from the newest sharded artifact, then train, taking
    the preemption vote before each step; once any rank was signalled,
    every rank saves the agreed step (``save_now``, a collective) and
    stops.  With ``hold`` the ranks wait after their first step until
    SIGTERM arrives, so the signal lands mid-run and not after it."""
    import signal
    import time

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import load_numpy_state
    from paddle_tpu_torch.parallel import checkpoint as ck
    from paddle_tpu_torch.parallel import distributed

    build_fn, batches_fn = dist_model.MODELS["mlp"]
    loss = build_fn(pt)
    load_numpy_state(pt.global_scope(), pt.default_startup_program(),
                     _state_in(inputs), "cpu")
    mgr = ck.ShardedCheckpointManager(str(inputs["ckpt"]), async_save=False)
    start = mgr.restore()
    if start is not None:
        print("RESUMED", start, flush=True)
    start = start or 0
    t = pt.DistributeTranspiler()
    t.transpile(trainer_id=rank, trainers=world)
    mesh = pt.make_mesh()
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             build_strategy=t.build_strategy(mesh),
                             mesh=mesh)
    flagged = []
    signal.signal(signal.SIGTERM, lambda signum, frame: flagged.append(1))
    data, losses, flush = batches_fn(), [], -1
    for i in range(start, len(data)):
        if distributed.any_process_flagged(flagged):
            mgr.save_now(i, executors=pe)
            flush = i
            print("CKPT_SAVED", i, flush=True)
            break
        lo = rank * (dist_model.BATCH // world)
        hi = lo + dist_model.BATCH // world
        (lv,) = pe.run([loss], feed={k: v[lo:hi] for k, v in data[i].items()},
                       local_feed=True)
        losses.append(float(np.asarray(lv).ravel()[0]))
        print("STEP", i, flush=True)
        deadline = time.monotonic() + 120
        while bool(inputs["hold"]) and not flagged and \
                time.monotonic() < deadline:
            time.sleep(0.02)
    return {"losses": np.array(losses), "flush": np.array(flush),
            "start": np.array(start)}


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}
CASES.update({"dist_" + w: _dist_case(w) for w in WORKLOADS})


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _jax_local(workload):
    """The JAX package's single-device losses and its startup state."""
    import paddle_tpu as fluid
    from paddle_tpu import unique_name

    build_fn, batches_fn = dist_model.MODELS[workload]
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start), unique_name.guard():
        loss = build_fn(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start, scope=scope)
    state = {"S:" + v.name: np.array(scope.find_var(v.name), copy=True)
             for v in start.list_vars() if v.persistable}
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).ravel()[0])
              for f in batches_fn()]
    return state, np.array(losses)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    refs, inputs = {}, {}
    for w in WORKLOADS:
        state, losses = _jax_local(w)
        inputs["dist_" + w] = state
        refs[w] = losses
    tmp = tmp_path_factory.mktemp("dist_world")
    ckpt = np.array(str(tmp / "trainer_ckpt"))
    inputs["trainer_flush"] = inputs["trainer_resume"] = {"ckpt": ckpt}
    res = run_world(os.path.abspath(__file__), WORLD,
                    sorted(set(CASES) - {"preempt"}), tmp, inputs)
    return res, inputs, refs


def _port_local(workload, state):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import load_numpy_state

    build_fn, batches_fn = dist_model.MODELS[workload]
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        loss = build_fn(pt)
    scope = pt.Scope()
    load_numpy_state(scope, start, _state_in(state), "cpu")
    exe = pt.Executor(pt.CPUPlace())
    return np.array([float(np.asarray(exe.run(
        main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0])
        for f in batches_fn()])


def _dist_parity(world, workload):
    res, inputs, refs = world
    port = _port_local(workload, inputs["dist_" + workload])
    for r in res["dist_" + workload]:
        assert not error_of(r), r.get("__trace__")
        np.testing.assert_allclose(r["losses"], refs[workload], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["losses"], port, rtol=1e-4, atol=1e-5)


def test_two_process_dist_matches_local(world):
    _dist_parity(world, "mlp")


def test_two_process_dist_sparse_grads_match_local(world):
    """SelectedRows gradients of the ranks' local batches gathered over the
    world aggregate to the single-process run's."""
    _dist_parity(world, "sparse")


@pytest.mark.parametrize("workload", ["text_cls", "word2vec"])
def test_two_process_dist_workload_matches_local(world, workload):
    _dist_parity(world, workload)


def test_transpiler_plan_matches_compiled_shardings(world):
    """The plan on a (dp 1, ep 2) mesh against what each rank holds: the
    table's rows over ep; the sliced weight, and the Adam moments of all
    three (kReduce's rule, which the plan fn leaves them to), ZeRO over dp
    (extent 1: whole); the bias replicated; one step runs (the table's
    moments resharded to its rows around its update)."""
    for r in world[0]["plan_shardings"]:
        assert not error_of(r), r.get("__trace__")
        got = dict(zip(r["names"].tolist(), zip(r["specs"].tolist(),
                                                r["shapes"].tolist())))
        assert got["table_w"] == ("PartitionSpec('ep',)", [32, 16])
        assert got["big_w"] == ("PartitionSpec('dp',)", [16, 1024])
        assert got["small_b"] == ("PartitionSpec()", [1024, 0])
        moments = {n: v for n, v in got.items() if "_moment" in n}
        assert len(moments) == 6
        for n, (spec, shape) in moments.items():
            assert spec == "PartitionSpec('dp',)", n
            assert shape == list(got[n.split("_moment")[0]][1]) or \
                n.startswith("table_w"), n
            if n.startswith("table_w"):
                assert shape == [64, 16]
        assert np.isfinite(r["loss"]).all()


def test_transpiler_sharding_plan():
    """The plan and its strategy fn, in this process (no world)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import PartitionSpec as P

    with pt.program_guard(pt.Program(), pt.Program()), \
            pt.unique_name.guard():
        ids = pt.layers.data("ids", shape=[4, 1], dtype="int64")
        emb = pt.layers.embedding(ids, size=[64, 16], is_distributed=True,
                                  param_attr=pt.ParamAttr(name="table_w"))
        big = pt.layers.fc(pt.layers.reduce_mean(emb, dim=1), size=1024,
                           param_attr=pt.ParamAttr(name="big_w"),
                           bias_attr=pt.ParamAttr(name="small_b"))
        pt.optimizer.SGD(learning_rate=0.1).minimize(pt.layers.mean(big))
        t = pt.DistributeTranspiler()
        t.transpile(trainer_id=0, trainers=2)
        plan = t.sharding_plan()
        assert plan["table_w"] == ("table", P("ep"))
        assert plan["big_w"][0] == "sliced"
        assert plan["small_b"][0] == "replicated"
        assert sorted(t.placement()) == sorted(
            ["table_w.block0", "big_w.block0", "big_w.block1",
             "small_b.block0"])
        bs = t.build_strategy(pt.make_mesh((8,), ("dp",)))
        assert bs.param_sharding_fn("table_w", (64, 16)) == P("dp")
        assert bs.param_sharding_fn("small_b", (1024,)) == P()
        assert bs.param_sharding_fn("big_w", (15, 1024)) == P()
        assert bs.param_sharding_fn("table_w", (63, 16)) == P()
        with pytest.raises(RuntimeError, match="no parameter-server role"):
            t.get_pserver_program("127.0.0.1:7164")
        with pytest.raises(NotImplementedError, match="async"):
            pt.DistributeTranspiler().transpile(trainer_id=0, trainers=2,
                                                sync_mode=False)
        with pytest.raises(ValueError, match="split_method"):
            cfg = pt.DistributeTranspilerConfig()
            cfg.split_method = "Nope"
            pt.DistributeTranspiler(cfg).transpile(trainer_id=0)


def test_slice_variable_accounting():
    from paddle_tpu_torch.transpiler.distribute_transpiler import \
        slice_variable

    class V:
        def __init__(self, name, shape):
            self.name, self.shape = name, shape

    blocks = slice_variable(
        [V("big", (1000, 64)), V("small", (4, 4)), V("row", (1, 100000))],
        slice_count=4)
    big = [b for b in blocks if b[0] == "big"]
    assert len(big) == 4
    assert sum(n for _, _, n in big) == 1000 * 64
    assert max(n for _, _, n in big) - min(n for _, _, n in big) == 0
    assert ("small", 0, 16) in blocks
    assert ("row", 0, 100000) in blocks
    assert len(slice_variable([V("t", (3, 10000))], slice_count=8)) == 3


def test_ps_dispatchers_equal_the_jax_package():
    from paddle_tpu.transpiler import ps_dispatcher as jd
    from paddle_tpu_torch.transpiler import ps_dispatcher as pd

    eps = ["a:1", "b:2", "c:3"]
    names = ["w%d" % i for i in range(10)]
    for cls in ("RoundRobin", "HashName"):
        assert getattr(pd, cls)(eps).dispatch(names) == \
            getattr(jd, cls)(eps).dispatch(names)
    with pytest.raises(NotImplementedError):
        pd.PSDispatcher(eps).dispatch(names)


def test_memory_optimize_reports():
    import paddle_tpu_torch as pt

    with pt.program_guard(pt.Program(), pt.Program()), \
            pt.unique_name.guard():
        x = pt.layers.data("x", shape=[16])
        pt.layers.mean(pt.layers.fc(x, size=32))
        assert pt.memory_optimize(pt.default_main_program(),
                                  print_log=False) >= 0
        assert pt.release_memory(pt.default_main_program()) == 0


def test_preemption_vote(world):
    for rank, r in enumerate(world[0]["vote"]):
        assert not bool(r["none"]) and bool(r["one"])
        assert int(r["count"]) == WORLD and int(r["id"]) == rank
    from paddle_tpu_torch.parallel import distributed

    # a process of its own: its own flag
    assert distributed.any_process_flagged(True) is True
    assert distributed.any_process_flagged(False) is False


def test_parallel_trainer_in_a_world_matches_one_device(world):
    """``Trainer(parallel=True)`` over 2 ranks: each rank's step losses are
    the single-device Trainer's."""
    want = _trainer_losses()
    for r in world[0]["trainer"]:
        assert not error_of(r), r.get("__trace__")
        np.testing.assert_allclose(r["losses"], want, rtol=1e-4,
                                   atol=1e-6)


def test_parallel_trainer_flushes_sharded_checkpoint_and_resumes(world):
    """``Trainer(parallel=True, checkpoint_config=)`` in a world writes
    sharded artifacts (the manager follows the world).  A signal on one
    rank stops both after the same step, whose periodic save is still
    committing: the flush writes no rank's shards a second time and
    leaves no tmp directory, and a fresh Trainer in the world resumes
    there and ends where the uninterrupted single-device run ends."""
    res, inputs, _ = world
    flush, resume = res["trainer_flush"], res["trainer_resume"]
    for r in flush + resume:
        assert not error_of(r), r.get("__trace__")
    want = _trainer_losses()
    for rank, r in enumerate(flush):
        assert len(r["losses"]) == FLUSH_STEP, r["losses"]
        assert r["writes"].tolist() == list(range(1, FLUSH_STEP + 1)), rank
        assert int(r["signals"]) == (rank == 1)
    assert flush[0]["entries"].tolist() == [
        "step_%010d" % s for s in range(1, FLUSH_STEP + 1)]
    man = json.loads(str(flush[0]["manifest"]))
    assert man["sharded"] and man["writers"] == WORLD
    for r in resume:
        assert int(r["load_serial"]) == FLUSH_STEP
        np.testing.assert_allclose(
            np.concatenate([flush[0]["losses"], r["losses"]]), want,
            rtol=1e-4, atol=1e-6)


def test_dist_trainer_kill_and_resume(world, tmp_path):
    """SIGTERM on both ranks mid-run: they agree on a flush step through
    the preemption vote, save it sharded, print it and exit 0; fresh
    ranks resume from it, and the losses joined match the single-device
    reference."""
    import signal

    _, inputs, refs = world
    ckpt = str(tmp_path / "preempt_ckpt")

    def inputs_for(hold):
        return {"preempt": dict(inputs["dist_mlp"], ckpt=np.array(ckpt),
                                hold=np.array(hold))}

    procs, out = start_world(os.path.abspath(__file__), WORLD, ["preempt"],
                             tmp_path / "run1", inputs_for(True))
    first = ""
    for line in procs[0].stdout:
        if line.startswith("STEP"):
            first = line
            for p in procs:
                p.send_signal(signal.SIGTERM)
            break
    assert first, procs[0].stderr.read()[-4000:]
    res1, stdout1 = finish_world(procs, out, ["preempt"], timeout=240)
    for r in res1["preempt"]:
        assert not error_of(r), r.get("__trace__")
    flush = {int(r["flush"]) for r in res1["preempt"]}
    assert len(flush) == 1 and flush.pop() == 1, res1["preempt"]
    assert "CKPT_SAVED 1" in stdout1[0] and "CKPT_SAVED 1" in stdout1[1]
    losses1 = res1["preempt"][0]["losses"].tolist()
    assert len(losses1) == 1
    man = json.load(open(os.path.join(ckpt, "step_0000000001",
                                      "MANIFEST.json")))
    assert man["sharded"] and man["writers"] == WORLD

    res2, stdout2 = finish_world(*start_world(
        os.path.abspath(__file__), WORLD, ["preempt"], tmp_path / "run2",
        inputs_for(False)), ["preempt"], timeout=240)
    for r, so in zip(res2["preempt"], stdout2):
        assert not error_of(r), r.get("__trace__")
        assert "RESUMED 1" in so and int(r["start"]) == 1
        assert int(r["flush"]) == -1
    losses = losses1 + res2["preempt"][0]["losses"].tolist()
    np.testing.assert_allclose(losses, refs["mlp"], rtol=1e-4, atol=1e-5)


def test_init_distributed_without_a_card_raises():
    from paddle_tpu_torch.parallel import distributed

    with pytest.raises(RuntimeError, match="CPUPlace"):
        distributed.init_distributed(num_processes=1, process_id=0)
    assert not distributed.is_initialized()
    distributed.shutdown()      # leaving no world is a no-op
    assert distributed.process_count() == 1


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
