"""The port's TrainState checkpoints (``paddle_tpu_torch/parallel/
checkpoint.py``) on the CPU, mirroring ``tests/test_train_state.py``:
capture and apply round trips (parameters, Adam's moments, the LR
counter, the executor's run counter and generators, the reader's
position), the atomic artifact and its manifest, the fallback past a
corrupt one, the async write, and exact resume.  Against the JAX package:
either package reads the other's artifacts bit for bit (bfloat16
included), and a dropout-free Adam MLP interrupted and resumed in both
packages from the same startup state follows the same trajectory within
rtol 1e-4, the reference's band."""

import json
import os
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.parallel import checkpoint as jax_ck

import paddle_tpu_torch as pt
from paddle_tpu_torch import fault, guardian, monitor
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.parallel import checkpoint as ck
from paddle_tpu_torch.reader import checkpointable
from paddle_tpu_torch.scope import global_scope

from test_torch_serving import fresh_torch_programs  # noqa: F401

CPU = pt.CPUPlace()


@pytest.fixture(autouse=True)
def _clean(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    fault.clear()
    guardian.uninstall()
    yield
    fault.clear()
    guardian.uninstall()
    monitor.reset_for_tests()


def _build(pkg=pt, seed=7, lr_decay=False, dropout=0.0):
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    x = pkg.layers.data("x", shape=[8])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(x, size=16, act="relu")
    if dropout:
        h = pkg.layers.dropout(h, dropout_prob=dropout)
    pred = pkg.layers.fc(h, size=4, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    lr = pkg.layers.exponential_decay(1e-2, decay_steps=3,
                                      decay_rate=0.7) if lr_decay else 1e-2
    pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return loss


def _batch(rng, n=4):
    return {"x": rng.rand(n, 8).astype("float32"),
            "label": rng.randint(0, 4, (n, 1)).astype("int64")}


def _persist_snap(scope, program):
    return {v.name: scope.find_var(v.name).clone()
            for v in program.global_block().vars.values()
            if v.persistable and scope.has_var(v.name)}


def _started():
    pt.Executor(CPU).run(pt.default_startup_program())
    return pt.default_main_program()


def test_capture_covers_full_train_state():
    """Parameters, Adam's moments and powers, the LR decay counter, and
    the executor's run counter and generator states."""
    loss = _build(lr_decay=True)
    _started()
    train_exe = pt.Executor(CPU)
    rng = np.random.RandomState(0)
    for _ in range(3):
        train_exe.run(feed=_batch(rng), fetch_list=[loss])
    ts = ck.capture_train_state(3, program=pt.default_main_program(),
                                executors={"train": train_exe})
    names = set(ts.arrays)
    assert any("moment" in n for n in names), names
    assert any("beta" in n for n in names), names
    assert any("LR_DECAY_COUNTER" in n for n in names), names
    ex = ts.host["executors"]["train"]
    assert ex["run_counter"] == 3 and list(ex["generators"]) == ["7"]
    assert ts.step == 3
    # private copies: the next step moves the scope, not the snapshot
    w = ts.arrays["fc_0.w_0"].clone()
    train_exe.run(feed=_batch(rng), fetch_list=[loss])
    assert torch.equal(ts.arrays["fc_0.w_0"], w)
    assert not torch.equal(global_scope().find_var("fc_0.w_0"), w)


def test_save_load_roundtrip_and_atomic_layout(tmp_path):
    loss = _build()
    _started()
    pt.Executor(CPU).run(feed=_batch(np.random.RandomState(1)),
                         fetch_list=[loss])
    ts = ck.capture_train_state(1, program=pt.default_main_program())
    d = str(tmp_path / "one")
    ck.save_train_state(d, ts)
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "arrays.npz",
                                     "train_state.json"]
    assert not [e for e in os.listdir(str(tmp_path))
                if e.startswith(".tmp.")]
    got = ck.load_train_state(d)
    assert got.step == 1 and set(got.arrays) == set(ts.arrays)
    for n in ts.arrays:
        assert got.arrays[n].dtype == ts.arrays[n].dtype
        assert torch.equal(got.arrays[n], ts.arrays[n]), n


def test_nonnative_dtype_roundtrip(tmp_path):
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(
        torch.bfloat16)
    ts = ck.TrainState(0, {"w": a, "b": torch.ones(3)}, {
        "format": ck.TRAIN_STATE_FORMAT, "step": 0, "executors": {},
        "readers": {}, "extra": {}})
    d = str(tmp_path / "bf16")
    ck.save_train_state(d, ts)
    got = ck.load_train_state(d)
    assert got.arrays["w"].dtype == torch.bfloat16
    assert torch.equal(got.arrays["w"], a)
    assert got.arrays["b"].dtype == torch.float32


def _jax_state():
    rng = np.random.RandomState(3)
    return {"w": (rng.randn(3, 5) * 7).astype(ml_dtypes.bfloat16),
            "m": rng.randn(4).astype("float32"),
            "n": np.arange(6, dtype="int64").reshape(2, 3)}


def test_jax_artifact_loads_in_the_port_bit_for_bit(tmp_path):
    """A JAX ``save_train_state`` artifact (bfloat16 as raw uint16 plus its
    logical name) loads in the port with equal bits."""
    arrays = _jax_state()
    ts = jax_ck.TrainState(4, arrays, {
        "format": 1, "step": 4, "executors": {"train": {"run_counter": 4}},
        "readers": {}, "extra": {"epoch": 1}})
    d = str(tmp_path / "jax")
    jax_ck.save_train_state(d, ts)
    got = ck.load_train_state(d)
    assert got.step == 4 and got.host["extra"] == {"epoch": 1}
    assert got.arrays["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.arrays["w"].view(torch.int16).numpy().view(np.uint16),
        arrays["w"].view(np.uint16))
    for n in ("m", "n"):
        np.testing.assert_array_equal(got.arrays[n].numpy(), arrays[n])
    # the JAX executor state (a run counter) sets the port's counter
    exe = pt.Executor(CPU)
    exe.load_state_dict(got.host["executors"]["train"])
    assert exe.state_dict()["run_counter"] == 4


def test_port_artifact_passes_the_jax_manifest_check(tmp_path):
    """The port's artifact passes the JAX loader's sha256 manifest check
    and gives the same arrays, bfloat16 included."""
    arrays = _jax_state()
    mine = {"w": torch.from_numpy(arrays["w"].view(np.int16)).view(
        torch.bfloat16), "m": torch.from_numpy(arrays["m"]),
        "n": torch.from_numpy(arrays["n"])}
    d = str(tmp_path / "port")
    ck.save_train_state(d, ck.TrainState(2, mine, {
        "format": 1, "step": 2, "executors": {}, "readers": {},
        "extra": {}}))
    got = jax_ck.load_train_state(d)
    assert got.step == 2
    assert got.arrays["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.arrays["w"].view(np.uint16),
                                  arrays["w"].view(np.uint16))
    for n in ("m", "n"):
        np.testing.assert_array_equal(got.arrays[n], arrays[n])


def test_corrupt_artifact_detected_and_restore_falls_back(tmp_path):
    loss = _build()
    prog = _started()
    exe = pt.Executor(CPU)
    rng = np.random.RandomState(2)
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "m"),
                                         async_save=False)
    exe.run(feed=_batch(rng), fetch_list=[loss])
    mgr.save(1, program=prog)
    want = _persist_snap(global_scope(), prog)
    exe.run(feed=_batch(rng), fetch_list=[loss])
    mgr.save(2, program=prog)
    assert mgr.all_steps() == [1, 2]
    victim = os.path.join(str(tmp_path / "m"), "step_%010d" % 2,
                          "arrays.npz")
    with open(victim, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef" * 4)
    with pytest.raises(ck.CheckpointCorruptError):
        ck.load_train_state(os.path.dirname(victim))
    os.makedirs(os.path.join(str(tmp_path / "m"), ".tmp.step_junk.123"))
    with pytest.warns(UserWarning, match="corrupt"):
        assert mgr.restore(program=prog) == 1
    got = _persist_snap(global_scope(), prog)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ck.CheckpointCorruptError):
        mgr.restore(program=prog, step=2)


def test_restore_with_no_valid_checkpoint_returns_none(tmp_path):
    _build()
    prog = _started()
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore(program=prog) is None


def test_strict_restore_rejects_model_mismatch():
    _build()
    prog = _started()
    ts = ck.capture_train_state(0, program=prog)
    del ts.arrays[sorted(ts.arrays)[0]]
    with pytest.raises(ck.CheckpointCorruptError, match="lacks"):
        ck.apply_train_state(ts, program=prog)
    ck.apply_train_state(ts, program=prog, strict=False)


def test_rotation_and_interval_gating(tmp_path):
    _build()
    prog = _started()
    mgr = ck.TrainStateCheckpointManager(
        str(tmp_path / "rot"), max_to_keep=2, save_interval_steps=3,
        async_save=False)
    saved = [s for s in range(1, 11) if mgr.save(s, program=prog)]
    assert saved == [1, 4, 7, 10]
    assert mgr.all_steps() == [7, 10]
    assert mgr.latest_step() == 10
    mgr2 = ck.TrainStateCheckpointManager(
        str(tmp_path / "rot"), max_to_keep=2, save_interval_steps=3)
    assert mgr2.save(11, program=prog) is False
    assert mgr2.save(13, program=prog) is True
    mgr2.close()


def test_async_save_overlaps_and_publishes_span(tmp_path, monkeypatch):
    _build()
    prog = _started()
    real = ck.save_train_state
    delay = 0.5

    def slow_save(dirname, ts):
        time.sleep(delay)
        return real(dirname, ts)

    monkeypatch.setattr(ck, "save_train_state", slow_save)
    monitor.enable()
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "a"),
                                         async_save=True)
    t0 = time.perf_counter()
    assert mgr.save(1, program=prog)
    assert time.perf_counter() - t0 < delay / 2
    assert threading.active_count() >= 2
    mgr.wait_until_finished()
    assert time.perf_counter() - t0 >= delay
    assert mgr.all_steps() == [1]
    assert set(mgr.measured_costs()) == {"snapshot_s", "save_s", "n"}
    text = monitor.expose_text()
    for name in ("span_checkpoint_save", "span_checkpoint_snapshot",
                 "mark_checkpoint_saved"):
        assert name in text, name


def test_async_write_failure_surfaces_on_next_call(tmp_path, monkeypatch):
    _build()
    prog = _started()

    def boom(dirname, ts):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_train_state", boom)
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "f"),
                                         async_save=True)
    assert mgr.save(1, program=prog)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait_until_finished()


def test_checkpointable_reader_position_roundtrip():
    src = lambda: iter(range(10))  # noqa: E731
    r = checkpointable(src)
    it = r()
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    st = r.state_dict()
    assert st == {"epoch": 0, "offset": 4}
    r2 = checkpointable(src)
    r2.load_state_dict(st)
    assert list(r2()) == [4, 5, 6, 7, 8, 9]
    assert r2.state_dict() == {"epoch": 1, "offset": 0}
    assert list(r2())[:3] == [0, 1, 2]


def _data_reader():
    rng = np.random.RandomState(42)
    for _ in range(64):
        yield _batch(rng)


def _resume_run(pkg, steps, reader, mgr=None, resume=False, save_at=None,
                dropout=0.3, state=None):
    """Train ``steps`` steps in a fresh world of ``pkg`` (its own programs,
    scope and names); ``state`` ({name: array}) replaces the port's
    startup values; with ``resume`` the manager's newest artifact is
    restored first, and at ``save_at`` one is saved.  The losses' bytes."""
    with pkg.unique_name.guard(), \
            pkg.program_guard(pkg.Program(), pkg.Program()), \
            pkg.scope_guard(pkg.Scope()):
        loss = _build(pkg, lr_decay=True, dropout=dropout)
        pkg.Executor(pkg.CPUPlace()).run(pkg.default_startup_program())
        prog = pkg.default_main_program()
        if state is not None:
            load_numpy_state(global_scope(), pkg.default_startup_program(),
                             state, "cpu")
        exe = pkg.Executor(pkg.CPUPlace())
        step = 0
        if resume:
            step = mgr.restore(program=prog, executors={"train": exe},
                               readers={"train": reader}) or 0
        it = iter(reader())
        losses = []
        while step < steps:
            (lv,) = exe.run(prog, feed=next(it), fetch_list=[loss])
            step += 1
            losses.append(np.asarray(lv).tobytes())
            if save_at == step:
                mgr.save_now(step, program=prog, executors={"train": exe},
                             readers={"train": reader})
        return losses


def test_exact_resume_loss_parity_in_process(tmp_path):
    """10 steps straight against 6, a checkpoint, a fresh world, a
    restore and 4 more: the losses are bit-equal (dropout from the
    executor's generator, the LR schedule, Adam's moments, the reader)."""
    ref = _resume_run(pt, 10, checkpointable(_data_reader))
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "e"),
                                         async_save=False)
    first = _resume_run(pt, 6, checkpointable(_data_reader), mgr=mgr,
                        save_at=6)
    rest = _resume_run(pt, 10, checkpointable(_data_reader), mgr=mgr,
                       resume=True)
    assert first + rest == ref
    # and not by accident: a fresh world without the restore differs
    assert _resume_run(pt, 4, checkpointable(_data_reader)) != rest


def test_exact_resume_follows_the_jax_package(tmp_path):
    """A dropout-free Adam MLP with an LR schedule, interrupted at step 6
    and resumed in each package, from the JAX startup's values carried
    across: each resumed trajectory equals its package's uninterrupted
    one bit for bit, and the port's follows the JAX package's within
    rtol 1e-4."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _build(fluid, lr_decay=True)
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in startup.list_vars() if v.persistable}

    def jax_run(steps, reader, mgr=None, resume=False, save_at=None):
        with fluid.unique_name.guard(), \
                fluid.program_guard(fluid.Program(), fluid.Program()), \
                fluid.scope_guard(fluid.Scope()):
            loss = _build(fluid, lr_decay=True)
            for n, v in state.items():
                fluid.global_scope().set_var(n, v.copy())
            prog = fluid.default_main_program()
            exe = fluid.Executor(fluid.CPUPlace())
            step = 0
            if resume:
                step = mgr.restore(program=prog, executors={"train": exe},
                                   readers={"train": reader}) or 0
            it = iter(reader())
            out = []
            while step < steps:
                (lv,) = exe.run(prog, feed=next(it), fetch_list=[loss])
                step += 1
                out.append(np.asarray(lv).tobytes())
                if save_at == step:
                    mgr.save_now(step, program=prog,
                                 executors={"train": exe},
                                 readers={"train": reader})
            return out

    from paddle_tpu.reader import checkpointable as jax_checkpointable

    jmgr = jax_ck.TrainStateCheckpointManager(str(tmp_path / "j"),
                                              async_save=False)
    jax_ref = jax_run(10, jax_checkpointable(_data_reader))
    jax_resumed = jax_run(6, jax_checkpointable(_data_reader), mgr=jmgr,
                          save_at=6) + jax_run(
        10, jax_checkpointable(_data_reader), mgr=jmgr, resume=True)
    assert jax_resumed == jax_ref
    pmgr = ck.TrainStateCheckpointManager(str(tmp_path / "p"),
                                          async_save=False)
    ref = _resume_run(pt, 10, checkpointable(_data_reader), dropout=0.0,
                      state=state)
    resumed = _resume_run(pt, 6, checkpointable(_data_reader), mgr=pmgr,
                          save_at=6, dropout=0.0, state=state) + _resume_run(
        pt, 10, checkpointable(_data_reader), mgr=pmgr, resume=True,
        dropout=0.0, state=state)
    assert resumed == ref
    np.testing.assert_allclose(
        np.frombuffer(b"".join(resumed), np.float32),
        np.frombuffer(b"".join(jax_resumed), np.float32), rtol=1e-4)


def test_strict_executor_name_mismatch_leaves_scope_untouched():
    loss = _build()
    prog = _started()
    train_exe = pt.Executor(CPU)
    rng = np.random.RandomState(3)
    train_exe.run(feed=_batch(rng), fetch_list=[loss])
    ts = ck.capture_train_state(1, program=prog,
                                executors={"train": train_exe})
    train_exe.run(feed=_batch(rng), fetch_list=[loss])
    after_step2 = _persist_snap(global_scope(), prog)
    with pytest.raises(ck.CheckpointCorruptError, match="executor"):
        ck.apply_train_state(ts, program=prog,
                             executors={"other_name": train_exe})
    now = _persist_snap(global_scope(), prog)
    for k in after_step2:
        assert torch.equal(now[k], after_step2[k]), k


def test_same_step_resave_and_save_now_noop(tmp_path):
    _build()
    prog = _started()
    root = str(tmp_path / "rs")
    mgr = ck.TrainStateCheckpointManager(root, async_save=False)
    assert mgr.save(1, program=prog)
    manifest = os.path.join(root, "step_%010d" % 1, "MANIFEST.json")
    first_mtime = os.path.getmtime(manifest)
    assert mgr.save_now(1, program=prog)
    assert os.path.getmtime(manifest) == first_mtime
    mgr2 = ck.TrainStateCheckpointManager(root, async_save=False)
    ts = ck.capture_train_state(1, program=prog)
    ck.save_train_state(os.path.join(root, "step_%010d" % 1), ts)
    got = ck.load_train_state(os.path.join(root, "step_%010d" % 1))
    assert got.step == 1 and mgr2.latest_step() == 1


def test_restore_reseeds_save_cadence_past_corrupt_latest(tmp_path):
    loss = _build()
    prog = _started()
    exe = pt.Executor(CPU)
    rng = np.random.RandomState(4)
    root = str(tmp_path / "c")
    mgr = ck.TrainStateCheckpointManager(root, async_save=False,
                                         save_interval_steps=5)
    exe.run(feed=_batch(rng), fetch_list=[loss])
    mgr.save(1, program=prog)
    for _ in range(5):
        exe.run(feed=_batch(rng), fetch_list=[loss])
    mgr.save(6, program=prog)
    victim = os.path.join(root, "step_%010d" % 6, "arrays.npz")
    with open(victim, "r+b") as f:
        f.seek(8)
        f.write(b"\x00" * 32)
    mgr2 = ck.TrainStateCheckpointManager(root, async_save=False,
                                          save_interval_steps=5)
    with pytest.warns(UserWarning, match="corrupt"):
        assert mgr2.restore(program=prog) == 1
    assert mgr2.save(3, program=prog) is False
    assert mgr2.save(6, program=prog) is True
    assert ck.load_train_state(os.path.dirname(victim)).step == 6


def test_restore_surfaces_model_mismatch_instead_of_fresh_start(tmp_path):
    _build()
    prog = _started()
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "mm"),
                                         async_save=False)
    mgr.save(1, program=prog)
    with pt.unique_name.guard(), \
            pt.program_guard(pt.Program(), pt.Program()), \
            pt.scope_guard(pt.Scope()):
        x = pt.layers.data("x", shape=[8])
        h = pt.layers.fc(x, size=32, act="relu")
        pred = pt.layers.fc(h, size=2)
        pt.optimizer.SGD(0.1).minimize(pt.layers.mean(pt.layers.square(
            pred)))
        pt.Executor(CPU).run(pt.default_startup_program())
        mgr2 = ck.TrainStateCheckpointManager(str(tmp_path / "mm"))
        with pytest.raises(ck.CheckpointMismatchError, match="model"):
            mgr2.restore(program=pt.default_main_program())


def test_sharded_paths_name_a7(tmp_path):
    """The six calls that refused naming A7 before the sharded half was
    ported: each now works, and bad input raises the JAX package's own
    error (no state to save or restore into; a full TrainState given to
    the sharded writer, a sharded one to the full writer)."""
    for call in (lambda: ck.save_sharded(str(tmp_path / "e")),
                 lambda: ck.load_sharded(str(tmp_path / "e"))):
        with pytest.raises(ValueError, match="startup program first"):
            call()
    _build()
    prog = _started()
    names = ck.save_sharded(str(tmp_path / "s"), program=prog)
    assert names == sorted(ck.capture_train_state(0, program=prog).arrays)
    assert ck.load_sharded(str(tmp_path / "s"), program=prog) == names
    mgr = ck.ShardedCheckpointManager(str(tmp_path / "m"), async_save=False)
    assert mgr.save(1, program=prog) and mgr.all_steps() == [1]
    ts = ck.capture_train_state(1, program=prog, sharded=True)
    parts = ck.partition_shards(ts, 2)
    assert len(parts) == 2 and sum(map(len, parts)) >= len(ts.shards)
    assert ck.save_train_state_sharded(str(tmp_path / "t"), ts) == \
        str(tmp_path / "t")
    assert sorted(ck.load_train_state(str(tmp_path / "t")).arrays) == names
    full = ck.capture_train_state(1, program=prog)
    with pytest.raises(ValueError, match="not captured sharded"):
        ck.save_train_state_sharded(str(tmp_path / "u"), full)
    with pytest.raises(ValueError, match="save_train_state_sharded"):
        ck.save_train_state(str(tmp_path / "u"), ts)
    sharded = ck.TrainStateCheckpointManager(str(tmp_path / "sm"),
                                             sharded=True, async_save=False)
    assert sharded.save(1, program=prog)
    assert json.load(open(os.path.join(sharded._step_dir(1),
                                       "MANIFEST.json")))["sharded"]
    assert sharded.restore(program=prog) == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_program_trains_in_the_other_package(tmp_path, writer):
    """``save_train_program`` in one package, ``load_train_program`` in
    the other: the loaded program (forward, backward, SGD) trains from
    the writer's startup values along the writer's own trajectory
    (rtol 1e-4), and the loss falls."""
    src, dst = (fluid, pt) if writer == "jax" else (pt, fluid)
    main, startup = src.Program(), src.Program()
    main.random_seed = startup.random_seed = 5
    with src.unique_name.guard(), src.program_guard(main, startup):
        x = src.layers.data("x", shape=[8])
        y = src.layers.data("y", shape=[1])
        pred = src.layers.fc(x, size=1, act=None)
        loss = src.layers.mean(src.layers.square(
            src.layers.elementwise_sub(pred, y)))
        src.optimizer.SGD(learning_rate=0.1).minimize(loss)
    src.io.save_train_program(str(tmp_path), main, startup,
                              loss_name=loss.name, feed_names=["x", "y"])
    rng = np.random.RandomState(0)
    xv = rng.rand(64, 8).astype("float32")
    feed = {"x": xv, "y": xv @ rng.rand(8, 1).astype("float32")}

    def train(pkg, prog, start, loss_name):
        scope = pkg.Scope()
        pkg.Executor(pkg.CPUPlace()).run(start, scope=scope)
        if pkg is pt:
            load_numpy_state(scope, start, init, "cpu")
        else:
            for n, v in init.items():
                scope.set_var(n, v.copy())
        exe = pkg.Executor(pkg.CPUPlace())
        return [float(np.ravel(exe.run(prog, feed=feed,
                                       fetch_list=[loss_name],
                                       scope=scope)[0])[0])
                for _ in range(30)]

    iscope = src.Scope()
    src.Executor(src.CPUPlace()).run(startup, scope=iscope)
    init = {v.name: np.array(iscope.find_var(v.name), copy=True)
            for v in startup.list_vars() if v.persistable}
    dmain, dstart, dloss, dfeeds = dst.io.load_train_program(str(tmp_path))
    assert dloss == loss.name and dfeeds == ["x", "y"]
    got = train(dst, dmain, dstart, dloss)
    want = train(src, main, startup, loss.name)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] * 0.1


def _trainer_parts():
    from paddle_tpu_torch.contrib import CheckpointConfig, Trainer

    def train_func():
        pt.default_main_program().random_seed = 7
        pt.default_startup_program().random_seed = 7
        x = pt.layers.data("x", shape=[8])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        h = pt.layers.dropout(pt.layers.fc(x, size=16, act="relu"), 0.3)
        pred = pt.layers.fc(h, size=4, act="softmax")
        return pt.layers.mean(pt.layers.cross_entropy(pred, label))

    def samples():
        rng = np.random.RandomState(0)
        for _ in range(48):
            x = rng.rand(8).astype("float32")
            yield x, np.array([int(np.argmax(x[:4]))], "int64")

    def make(ckpt_dir):
        cfg = CheckpointConfig(checkpoint_dir=ckpt_dir, step_interval=4)
        return Trainer(train_func, lambda: pt.optimizer.Adam(
            pt.layers.exponential_decay(1e-2, 3, 0.7)), place=CPU,
            checkpoint_config=cfg), cfg

    return make, lambda: checkpointable(pt.batch(samples, 4))


def _train(trainer, reader, on_step=None):
    """Two epochs of ``trainer``; ``on_step(n)`` after the n-th step.
    The losses' bytes."""
    losses = []

    def handler(ev):
        if hasattr(ev, "metrics"):
            losses.append(ev.metrics[0].tobytes())
            if on_step is not None:
                on_step(len(losses))

    trainer.train(2, handler, reader=reader, feed_order=["x", "label"])
    return losses


def test_trainer_auto_resumes_exactly(tmp_path):
    """A Trainer over a checkpoint directory resumes at its newest
    artifact (``load_serial``): the epoch, the reader's position, the
    generator and the LR counter, so the two legs' losses are the
    uninterrupted run's."""
    make, reader = _trainer_parts()
    ref = _train(make(str(tmp_path / "ref"))[0], reader())
    t1, _ = make(str(tmp_path / "ck"))
    first = _train(t1, reader(), lambda n: n == 15 and t1.stop())
    t2, cfg = make(str(tmp_path / "ck"))
    assert cfg.load_serial == 13      # saves at steps 1, 5, 9, 13
    assert first[:13] + _train(t2, reader()) == ref


def test_sigterm_flushes_a_checkpoint_and_reraises(tmp_path):
    """SIGTERM mid-epoch: the step finishes, a synchronous artifact lands
    at that step (``preempted`` in its extras), the signal reaches the
    previous handler, and a new Trainer resumes exactly from there."""
    import signal

    make, reader = _trainer_parts()
    ref = _train(make(str(tmp_path / "ref"))[0], reader())
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        t1, _ = make(str(tmp_path / "ck"))
        first = _train(t1, reader(), lambda n: n == 7 and os.kill(
            os.getpid(), signal.SIGTERM))
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert got == [signal.SIGTERM] and len(first) == 7
    ts = ck.load_train_state(os.path.join(str(tmp_path / "ck"),
                                          "step_%010d" % 7))
    assert ts.host["extra"]["preempted"] is True
    t2, cfg = make(str(tmp_path / "ck"))
    assert cfg.load_serial == 7
    assert first + _train(t2, reader()) == ref
