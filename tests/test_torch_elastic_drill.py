"""Kill-and-resume drills of the port's TrainState checkpoints, mirroring
``tests/test_elastic_drill.py``.

A trainer subprocess runs a fixed-seed MLP (dropout from the executor's
generator, an LR schedule, Adam, a checkpointable reader) with async
checkpoints every 5 steps and logs each loss's bits.  A
``fault.kill_mid_save`` drill SIGKILLs it inside the step-11 write, at the
``before_commit`` point, leaving a torn ``.tmp.`` artifact; a second
subprocess resumes from the newest intact artifact and runs to the end.
Every logged loss, of the killed run, the replayed steps and the resumed
run, is bit-equal to an uninterrupted run in this process.  A corrupted
latest artifact makes the resume fall back one more.  Three subprocesses
in all.

The mesh-size-change resume (``test_elastic_drill.py:216``): a gloo
world of 4 (``torch_mesh_world``; each rank ``python
tests/test_torch_elastic_drill.py --rank R ...``) trains an Adam MLP on a
(dp 1, fsdp 4) mesh and saves a sharded artifact, each rank writing the
blocks it owns; the world of 4, a world of 2 and this process (one
rank) restore it through their own ``state_shardings()`` and train on.
Each is held against the state fsdp 4 held when it saved and against an
uninterrupted run of the same steps in one process.  The JAX test
restores onto fsdp 2 and 8; this one onto 2 and 1, since a world of 8
processes does not fit beside the parallel test workers on an 8-core
host.

The ``cuda``-marked tests skip without a card (on the card:
``python -m pytest -m cuda tests/test_torch_elastic_drill.py``): resume
and rollback into captured entries, and the skip guard inside a CUDA
graph.  This file imports no JAX."""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import fault, framework, guardian, monitor, unique_name
from paddle_tpu_torch.parallel import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_mesh_world import error_of, run_world  # noqa: E402

TOTAL_STEPS = 18
KILL_STEP = 11

TRAINER_SRC = r'''
import json, os, sys
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch import fault
from paddle_tpu_torch.parallel import checkpoint as ck
from paddle_tpu_torch.reader import checkpointable


def build():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[8])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        h = pt.layers.fc(x, size=16, act="relu")
        h = pt.layers.dropout(h, dropout_prob=0.3)
        pred = pt.layers.fc(h, size=4, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        lr = pt.layers.exponential_decay(1e-2, decay_steps=4,
                                         decay_rate=0.8)
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def data_reader():
    rng = np.random.RandomState(0)
    for _ in range(1000):
        yield {"x": rng.rand(4, 8).astype("float32"),
               "label": rng.randint(0, 4, (4, 1)).astype("int64")}


def train(ckpt_dir, total, kill_step, log=None):
    """Train to ``total`` steps, checkpointing into ``ckpt_dir`` (None:
    no checkpoints) and resuming from it; ``kill_step``: SIGKILL inside
    that step's write.  Returns the loss bits of each step run."""
    main, startup, loss = build()
    reader = checkpointable(data_reader)
    if kill_step:
        fault.kill_mid_save(fault.FaultSchedule(steps=[kill_step]))
    scope = pt.Scope()
    place = pt.CPUPlace()
    pt.Executor(place).run(startup, scope=scope)
    exe = pt.Executor(place)
    mgr = step = None
    if ckpt_dir:
        mgr = ck.TrainStateCheckpointManager(ckpt_dir, max_to_keep=3,
                                             save_interval_steps=5)
        step = mgr.restore(scope=scope, program=main,
                           executors={"train": exe},
                           readers={"train": reader})
        if step is not None:
            print("RESUMED", step, flush=True)
    step = step or 0
    out = {}
    it = iter(reader())
    while step < total:
        (lv,) = exe.run(main, feed=next(it), fetch_list=[loss],
                        scope=scope)
        step += 1
        out[step] = lv.tobytes().hex()
        if log is not None:
            log.write(json.dumps({"step": step, "loss_hex": out[step]})
                      + chr(10))
            log.flush()
            os.fsync(log.fileno())
        if mgr is not None:
            mgr.save(step, scope=scope, program=main,
                     executors={"train": exe}, readers={"train": reader})
    if mgr is not None:
        mgr.wait_until_finished()
    print("DONE", step, flush=True)
    return out


if __name__ == "__main__":
    with open(sys.argv[2], "a") as log:
        train(sys.argv[1], int(sys.argv[3]), int(sys.argv[4]), log)
'''


@pytest.fixture(autouse=True)
def _clean():
    """Fresh default programs, scope and name counter (this file imports
    no JAX, so not ``test_torch_serving``'s fixture), and the monitor,
    the fault registry and the guardian reset."""
    old_main = framework.switch_main_program(pt.Program())
    old_startup = framework.switch_startup_program(pt.Program())
    old_gen = unique_name.switch()
    monitor.reset_for_tests()
    fault.clear()
    guardian.uninstall()
    with pt.scope_guard(pt.Scope()):
        yield
    fault.clear()
    guardian.uninstall()
    pt.flags.set_flags({"guardian": False})
    monitor.reset_for_tests()
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)


def _trainer(tmp):
    path = os.path.join(str(tmp), "trainer.py")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(TRAINER_SRC)
    return path


def _run_trainer(tmp, ckpt_dir, log_path, kill_step=0, expect_kill=False):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, _trainer(tmp), str(ckpt_dir), str(log_path),
         str(TOTAL_STEPS), str(kill_step)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        timeout=300)
    want = -signal.SIGKILL if expect_kill else 0
    assert p.returncode == want, (p.returncode, p.stderr[-3000:])
    return p


def _losses(log_path):
    """step -> the set of loss bits logged for it (a step replayed after
    the kill is logged twice; a line torn by the kill is skipped)."""
    out = {}
    with open(log_path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            out.setdefault(rec["step"], set()).add(rec["loss_hex"])
    return out


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The uninterrupted reference, run in this process, and one trainer
    subprocess killed inside the step-11 write."""
    tmp = tmp_path_factory.mktemp("drill")
    space = {"__name__": "drill_trainer"}
    exec(compile(TRAINER_SRC, "trainer.py", "exec"), space)
    fault.clear()
    ref = space["train"](None, TOTAL_STEPS, 0)
    fault.clear()
    assert sorted(ref) == list(range(1, TOTAL_STEPS + 1))
    ckpt, log = tmp / "ckpt", tmp / "drill.jsonl"
    _run_trainer(tmp, ckpt, log, kill_step=KILL_STEP, expect_kill=True)
    return {"ref": ref, "ckpt": str(ckpt), "log": str(log), "tmp": tmp}


def _copy(drill, tmp_path):
    ckpt, log = tmp_path / "ckpt", tmp_path / "drill.jsonl"
    shutil.copytree(drill["ckpt"], str(ckpt))
    shutil.copy(drill["log"], str(log))
    return ckpt, log


def test_kill9_mid_save_resume_loss_trajectory_bit_identical(drill,
                                                             tmp_path):
    """The kill left steps 1 and 6 committed and step 11 torn; the resume
    starts at step 6 and every logged loss equals the reference's."""
    ckpt, log = _copy(drill, tmp_path)
    killed = _losses(str(log))
    assert max(killed) >= KILL_STEP
    assert sorted(e for e in os.listdir(str(ckpt))
                  if e.startswith("step_")) == ["step_%010d" % 1,
                                                "step_%010d" % 6]
    assert any(e.startswith(".tmp.") for e in os.listdir(str(ckpt)))
    p = _run_trainer(tmp_path, ckpt, log)
    assert int(p.stdout.split("RESUMED")[1].split()[0]) == 6
    assert "DONE %d" % TOTAL_STEPS in p.stdout
    combined = _losses(str(log))
    assert sorted(combined) == list(range(1, TOTAL_STEPS + 1))
    for step, hexes in combined.items():
        assert hexes == {drill["ref"][step]}, "step %d diverged" % step
    assert not any(e.startswith(".tmp.") for e in os.listdir(str(ckpt)))


def test_corrupt_latest_checkpoint_falls_back_on_resume(drill, tmp_path):
    """The latest committed artifact garbled after the kill: the resume
    falls back to the one before and still reproduces the reference."""
    ckpt, log = _copy(drill, tmp_path)
    with open(os.path.join(str(ckpt), "step_%010d" % 6, "arrays.npz"),
              "r+b") as f:
        f.seek(16)
        f.write(b"\xff" * 64)
    p = _run_trainer(tmp_path, ckpt, log)
    assert int(p.stdout.split("RESUMED")[1].split()[0]) == 1
    combined = _losses(str(log))
    assert sorted(combined) == list(range(1, TOTAL_STEPS + 1))
    for step, hexes in combined.items():
        assert hexes == {drill["ref"][step]}, "step %d diverged" % step


# ---------------------------------------------------------------------------
# on the card: captured entries
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return pt.CUDAPlace(0)


def _card_mlp():
    space = {"__name__": "card_trainer"}
    exec(compile(TRAINER_SRC, "trainer.py", "exec"), space)
    main, startup, loss = space["build"]()
    feeds = [f for _, f in zip(range(12), space["data_reader"]())]
    return main, startup, loss, feeds


def _state(scope, program):
    return {v.name: scope.find_var(v.name).detach().cpu().clone()
            for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


@pytest.mark.cuda
def test_captured_resume_is_bit_identical(card, tmp_path):
    """8 captured steps straight, against 4, an async save, a fresh
    executor and scope, a restore and 4 more: equal loss bits and state,
    one graph per entry."""
    main, startup, loss, feeds = _card_mlp()

    def fresh():
        scope = pt.Scope()
        pt.Executor(card).run(startup, scope=scope)
        return scope, pt.Executor(card)

    scope, exe = fresh()
    ref = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           .tobytes() for f in feeds[:8]]
    want = _state(scope, main)
    scope, exe = fresh()
    mgr = ck.TrainStateCheckpointManager(str(tmp_path), async_save=True)
    got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           .tobytes() for f in feeds[:4]]
    mgr.save(4, scope=scope, program=main, executors={"train": exe})
    mgr.wait_until_finished()
    scope, exe = fresh()
    assert mgr.restore(scope=scope, program=main,
                       executors={"train": exe}) == 4
    got += [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            .tobytes() for f in feeds[4:8]]
    assert got == ref
    for n, t in _state(scope, main).items():
        assert torch.equal(t, want[n]), n
    assert sorted(st.graphs for st in exe._steps.values()) == [1]


@pytest.mark.cuda
def test_rollback_into_a_live_captured_entry_keeps_its_graph(card):
    """A state restored into a running executor (its generator registered
    with the entry's graph) replays the steps from there with the bits
    they had, and the entry keeps its one graph."""
    main, startup, loss, feeds = _card_mlp()
    scope = pt.Scope()
    pt.Executor(card).run(startup, scope=scope)
    exe = pt.Executor(card)
    for f in feeds[:3]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    ts = ck.capture_train_state(3, scope=scope, program=main,
                                executors={"train": exe})
    first = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
             .tobytes() for f in feeds[3:7]]
    graph = next(iter(exe._steps.values())).graph
    ck.apply_train_state(ts, scope=scope, program=main,
                         executors={"train": exe})
    again = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
             .tobytes() for f in feeds[3:7]]
    assert again == first
    assert next(iter(exe._steps.values())).graph is graph
    assert sorted(st.graphs for st in exe._steps.values()) == [1]


@pytest.mark.cuda
def test_captured_skip_guard_keeps_state_bit_equal(card):
    """The skip guard inside the graph: a poisoned replay leaves every
    state variable bit-equal, and the captured run's losses and state
    equal the eager (``capture=False``) run's."""
    main, startup, loss, feeds = _card_mlp()
    pt.flags.set_flags({"guardian": True})
    runs = {}
    for capture in (True, False):
        scope = pt.Scope()
        pt.Executor(card).run(startup, scope=scope)
        g = guardian.install(guardian.Guardian(policy="skip,abort"))
        fault.poison_batch("x", fault.FaultSchedule(steps=[4]))
        exe = pt.Executor(card, capture=capture)
        losses, kept = [], None
        for i, f in enumerate(feeds[:8]):
            if i == 4:
                before = _state(scope, main)
            losses.append(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0].tobytes())
            if i == 4:
                kept = all(torch.equal(t, before[n])
                           for n, t in _state(scope, main).items())
        g.flush()
        assert kept and g.stats()["skipped_steps"] == 1
        guardian.uninstall()
        fault.clear()
        runs[capture] = (losses, _state(scope, main), exe)
    assert runs[True][0] == runs[False][0]
    for n, t in runs[True][1].items():
        assert torch.equal(t, runs[False][1][n]), n
    assert sorted(st.graphs for st in runs[True][2]._steps.values()) == [1]


# ---------------------------------------------------------------------------
# the mesh-size-change resume through a sharded artifact
# ---------------------------------------------------------------------------

ELASTIC_STEPS = 4


def _elastic_build():
    pt.default_main_program().random_seed = 7
    pt.default_startup_program().random_seed = 7
    x = pt.layers.data("x", shape=[16])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    h = pt.layers.fc(x, size=32, act="relu")
    pred = pt.layers.fc(h, size=4, act=None)
    loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(pred, label))
    pt.optimizer.Adam(learning_rate=2e-3).minimize(loss)
    return loss


def _elastic_batch(step):
    x = np.random.RandomState(100 + step).rand(8, 16).astype("float32")
    return {"x": x, "label": x[:, :4].argmax(1).astype("int64")
            .reshape(-1, 1)}


def _elastic_run(ckpt, restore, steps, fsdp):
    """A (dp 1, fsdp) mesh over the world: restore (optionally) through
    ``state_shardings()``, run ``steps``, and without ``restore`` save a
    sharded artifact at the last one.  Returns the losses and the state
    gathered whole (``capture_train_state`` without ``sharded``, a
    collective apart from the sharded path): after a restore the values
    restored (``V:``), else the values saved (``S:``)."""
    loss = _elastic_build()
    bs = pt.BuildStrategy()
    bs.sharding_rules = True
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             mesh=pt.make_mesh((1, fsdp), ("dp", "fsdp")),
                             build_strategy=bs)
    mgr = ck.TrainStateCheckpointManager(ckpt, sharded=True,
                                         async_save=False,
                                         save_interval_steps=1000)
    out, start = {}, 0
    if restore:
        start = mgr.restore(executors={"train": pe},
                            shardings=pe.state_shardings())
        assert start is not None
        out.update(_whole("V:", start, pe))
    losses = [float(np.asarray(pe.run([loss], feed=_elastic_batch(s))[0])
                    .ravel()[0]) for s in range(start + 1,
                                                start + 1 + ELASTIC_STEPS)]
    if not restore:
        out.update(_whole("S:", start + ELASTIC_STEPS, pe))
        mgr.save_now(start + ELASTIC_STEPS, executors={"train": pe})
    out["losses"] = np.array(losses)
    return out


def _whole(prefix, step, pe=None):
    return {prefix + n: t.numpy() for n, t in ck.capture_train_state(
        step, executors=pe).arrays.items()}


def _elastic_uninterrupted():
    """The run the resume stands in for: 2 x ``ELASTIC_STEPS`` steps in
    one process through the plain ``Executor`` (no mesh, no checkpoint).
    Returns the losses and the state after the first half (``U:``)."""
    loss = _elastic_build()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    out, losses = {}, []
    for s in range(1, 2 * ELASTIC_STEPS + 1):
        losses.append(float(np.asarray(exe.run(
            feed=_elastic_batch(s), fetch_list=[loss])[0]).ravel()[0]))
        if s == ELASTIC_STEPS:
            out.update(_whole("U:", s))
    out["losses"] = np.array(losses)
    return out


def case_elastic_save(inputs, rank, world):
    return _elastic_run(str(inputs["ckpt"]), False, ELASTIC_STEPS, world)


def case_elastic_resume(inputs, rank, world):
    return _elastic_run(str(inputs["ckpt"]), True, ELASTIC_STEPS, world)


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def _prefixed(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def test_mesh_size_change_resume_sharded_artifact(tmp_path):
    """fsdp 4 saves a sharded artifact (one shard file a rank); fsdp 4,
    fsdp 2 and one process restore it.  The values each restores are
    bit-identical to the state fsdp 4 held when it saved, which is the
    uninterrupted one-process run's state at that step (rtol 1e-5); the
    losses before the save and each continuation's after it stay within
    rtol 1e-4 of the uninterrupted run's."""
    ckpt = str(tmp_path / "ck")
    ref = _elastic_uninterrupted()
    res4 = run_world(os.path.abspath(__file__), 4,
                     ["elastic_save", "elastic_resume"], tmp_path / "w4",
                     {"elastic_save": {"ckpt": np.array(ckpt)},
                      "elastic_resume": {"ckpt": np.array(ckpt)}})
    for case in res4.values():
        for r in case:
            assert not error_of(r), r.get("__trace__")
    steps = [d for d in os.listdir(ckpt) if d.startswith("step_")]
    assert steps == ["step_%010d" % ELASTIC_STEPS]
    man = json.load(open(os.path.join(ckpt, steps[0], "MANIFEST.json")))
    assert man["sharded"] and man["writers"] == 4
    saved = _prefixed(res4["elastic_save"][0], "S:")
    want = _prefixed(ref, "U:")
    assert sorted(saved) == sorted(want)
    for k, v in saved.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(res4["elastic_save"][0]["losses"],
                               ref["losses"][:ELASTIC_STEPS], rtol=1e-4,
                               atol=1e-6)
    res2 = run_world(os.path.abspath(__file__), 2, ["elastic_resume"],
                     tmp_path / "w2",
                     {"elastic_resume": {"ckpt": np.array(ckpt)}})
    assert not error_of(res2["elastic_resume"][0]), \
        res2["elastic_resume"][0].get("__trace__")
    framework.switch_main_program(pt.Program())
    framework.switch_startup_program(pt.Program())
    unique_name.switch()
    one = _elastic_run(ckpt, True, ELASTIC_STEPS, 1)
    for name, cont in (("fsdp 4", res4["elastic_resume"][0]),
                       ("fsdp 2", res2["elastic_resume"][0]),
                       ("one process", one)):
        vals = _prefixed(cont, "V:")
        assert sorted(vals) == sorted(saved), name
        for k, v in vals.items():
            np.testing.assert_array_equal(v, saved[k], err_msg=k)
        np.testing.assert_allclose(cont["losses"],
                                   ref["losses"][ELASTIC_STEPS:],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
