"""Kill-and-resume drills of the port's TrainState checkpoints, mirroring
``tests/test_elastic_drill.py`` (less its mesh-resize test, which waits
for ROADMAP A7).

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
