"""The port's fault-injection harness (``paddle_tpu_torch/fault.py``) on
the CPU, mirroring ``tests/test_fault.py``: schedules are pure functions
of (seed, step), drills install through the registry, the helpers or
``FLAGS_fault_spec``, two runs with the same schedules inject at the same
points, and the port's executor fires its points at the step indices the
JAX executor fires them at.  The kill-mid-save family is drilled end to
end in ``tests/test_torch_elastic_drill.py``."""

import tempfile
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import fault as jax_fault

import paddle_tpu_torch as pt
from paddle_tpu_torch import fault, guardian, monitor
from paddle_tpu_torch.parallel import checkpoint as ck

from test_torch_serving import fresh_torch_programs  # noqa: F401


@pytest.fixture(autouse=True)
def _clean(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    fault.clear()
    fault.clear_injections()
    guardian.uninstall()
    yield
    fault.clear()
    fault.clear_injections()
    guardian.uninstall()
    pt.flags.set_flags({"fault_spec": "", "guardian": False})
    monitor.reset_for_tests()


def test_schedule_forms_and_determinism():
    s = fault.FaultSchedule(steps=[3, 7])
    assert [i for i in range(10) if s.fires(i)] == [3, 7]
    p = fault.FaultSchedule(every=4, start=2)
    assert [i for i in range(12) if p.fires(i)] == [2, 6, 10]
    a = fault.FaultSchedule(prob=0.3, seed=42)
    b = fault.FaultSchedule(prob=0.3, seed=42)
    pat_a = [a.fires(i) for i in range(300)]
    assert pat_a == [b.fires(i) for i in range(300)]
    assert 30 < sum(pat_a) < 160
    c = fault.FaultSchedule(prob=0.3, seed=43)
    assert pat_a != [c.fires(i) for i in range(300)]
    assert [a.fires(i) for i in range(300)] == pat_a
    # the seeded hash is the JAX package's: the same steps fire
    j = jax_fault.FaultSchedule(prob=0.3, seed=42)
    assert pat_a == [j.fires(i) for i in range(300)]


def test_empty_schedule_rejected():
    with pytest.raises(ValueError):
        fault.FaultSchedule()
    with pytest.raises(TypeError):
        fault.register("executor/feed", lambda step: None, schedule=None)


def test_register_fire_once_and_unregister():
    hits = []
    h = fault.register("executor/dispatch",
                       lambda step, **ctx: hits.append(step),
                       fault.FaultSchedule(steps=[1, 3]), once=True)
    assert fault.active()
    for i in range(5):
        fault.fire("executor/dispatch", i)
    assert hits == [1]
    assert fault.injections() == [("executor/dispatch", 1, h.name)]
    fault.unregister(h)
    assert not fault.active()


def _build_mlp(pkg=pt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=4, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _batches(n, bs=4):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(bs, 8).astype("float32"),
             "label": rng.randint(0, 4, (bs, 1)).astype("int64")}
            for _ in range(n)]


def _drilled_run(pkg, mod, steps=6):
    """One executor run of ``pkg`` with a poisoned batch, a NaN'd loss
    fetch and a NaN'd weight on fixed schedules (``mod``: that package's
    fault module); (losses, injection log)."""
    mod.clear()
    mod.clear_injections()
    main, startup, loss = _build_mlp(pkg)
    mod.poison_batch("x", mod.FaultSchedule(steps=[2]))
    mod.inject_nan(loss.name, mod.FaultSchedule(steps=[4]))
    mod.delay_dispatch(0.0, mod.FaultSchedule(every=3, start=1))
    scope = pkg.Scope()
    out = []
    pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
    exe = pkg.Executor(pkg.CPUPlace())
    for feed in _batches(steps):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        out.append(np.asarray(lv, "float32").tobytes())
    log = mod.injections()
    mod.clear()
    mod.clear_injections()
    return out, log


def test_injection_points_identical_across_runs():
    """Same schedules, same injection points and loss bits, two runs."""
    out1, log1 = _drilled_run(pt, fault)
    out2, log2 = _drilled_run(pt, fault)
    assert log1 == log2
    assert [(p, s) for p, s, _ in log1] == [
        ("executor/dispatch", 1), ("executor/feed", 2),
        ("executor/dispatch", 4), ("executor/step_done", 4)]
    assert out1 == out2
    assert not np.isfinite(np.frombuffer(out1[2], "float32")).all()
    assert not np.isfinite(np.frombuffer(out1[4], "float32")).all()


def test_fault_firings_match_the_jax_executor():
    """The port's executor fires each point at the step index, and in the
    order, the JAX executor does."""
    _, pt_log = _drilled_run(pt, fault)
    _, jax_log = _drilled_run(fluid, jax_fault)
    assert pt_log == jax_log


def test_inject_nan_into_scope_var():
    main, startup, loss = _build_mlp()
    fault.inject_nan("fc_0.w_0", fault.FaultSchedule(steps=[1]))
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _batches(3)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    assert torch.isfinite(scope.find_var("fc_0.w_0")).all()
    exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
    w = scope.find_var("fc_0.w_0")
    assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
    assert not torch.isfinite(w).any()
    (lv,) = exe.run(main, feed=feeds[2], fetch_list=[loss], scope=scope)
    assert not np.isfinite(lv).all()


def test_inject_nan_unknown_var_raises():
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    fault.inject_nan("no_such_var", fault.FaultSchedule(steps=[0]))
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(KeyError, match="no_such_var"):
        exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)


def test_poison_batch_misaimed_raises():
    fault.poison_batch("lbl", fault.FaultSchedule(steps=[0]))
    with pytest.raises(KeyError, match="not a feed"):
        fault.fire("executor/feed", 0, feed_names=["label", "x"],
                   feed_vals=[torch.zeros((2, 1), dtype=torch.int64),
                              torch.zeros((2, 4))])
    fault.clear()
    fault.poison_batch("label", fault.FaultSchedule(steps=[0]))
    with pytest.raises(TypeError, match="non-float"):
        fault.fire("executor/feed", 0, feed_names=["label"],
                   feed_vals=[torch.zeros((2, 1), dtype=torch.int64)])


def test_poison_batch_keeps_dtype_and_shape():
    fault.poison_batch("x", fault.FaultSchedule(steps=[0, 1]), fill=1e30)
    vals = [torch.zeros((2, 4), dtype=torch.bfloat16)]
    fault.fire("executor/feed", 0, feed_names=["x"], feed_vals=vals)
    assert vals[0].dtype == torch.bfloat16 and vals[0].shape == (2, 4)
    assert float(vals[0][0, 0]) > 1e29
    vals = [np.zeros((3,), "float32")]
    fault.fire("executor/feed", 1, feed_names=["x"], feed_vals=vals)
    assert vals[0].dtype == np.float32 and (vals[0] == 1e30).all()
    # an integer feed takes an integral fill: zero lengths
    fault.poison_batch("x@LEN", fault.FaultSchedule(steps=[2]), fill=0)
    vals = [torch.full((4,), 7, dtype=torch.int32)]
    fault.fire("executor/feed", 2, feed_names=["x@LEN"], feed_vals=vals)
    assert vals[0].dtype == torch.int32 and vals[0].eq(0).all()


def test_fail_and_delay_dispatch():
    main, startup, loss = _build_mlp()
    fault.fail_dispatch(fault.FaultSchedule(steps=[1]))
    fault.delay_dispatch(0.05, fault.FaultSchedule(steps=[0]))
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _batches(3)
    t0 = time.perf_counter()
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    assert time.perf_counter() - t0 > 0.04
    with pytest.raises(fault.FaultInjectedError):
        exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
    exe.run(main, feed=feeds[2], fetch_list=[loss], scope=scope)


def test_checkpoint_write_points_fire():
    seen = []
    for point in ("before_write", "after_write", "before_commit"):
        fault.register(
            "checkpoint/" + point,
            lambda step, _p=point, **ctx: seen.append((_p, step)),
            fault.FaultSchedule(every=1))
    ts = ck.TrainState(5, {"w": torch.zeros((2, 2))},
                       {"format": 1, "step": 5, "executors": {},
                        "readers": {}, "extra": {}})
    with tempfile.TemporaryDirectory() as d:
        ck.save_train_state(d + "/step_0000000005", ts)
    assert seen == [("before_write", 5), ("after_write", 5),
                    ("before_commit", 5)]


def test_private_fault_hooks_are_gone():
    assert not hasattr(ck, "_FAULT_HOOKS")


def test_install_from_spec_grammar():
    hooks = fault.install_from_spec(
        "nan_var:fc_0.w_0@5;poison_batch:x@3,9:once;"
        "delay:0.01@every=4+2;fail_dispatch:@prob=0.5;"
        "kill_save:before_commit@11")
    assert len(hooks) == 5
    assert {h.name for h in hooks} == {
        "nan_var:fc_0.w_0", "poison_batch:x", "delay_dispatch:0.01s",
        "fail_dispatch", "kill_mid_save:before_commit"}
    by_name = {h.name: h for h in hooks}
    assert by_name["nan_var:fc_0.w_0"].once
    assert by_name["poison_batch:x"].once
    assert not by_name["delay_dispatch:0.01s"].once
    assert by_name["delay_dispatch:0.01s"].schedule.fires(6)
    assert not by_name["delay_dispatch:0.01s"].schedule.fires(7)


def test_install_from_spec_rejects_malformed():
    for bad in ("nonsense", "unknown_family:x@3", "nan_var:w@",
                "delay:notafloat@3"):
        with pytest.raises(ValueError):
            fault.install_from_spec(bad)


def test_fault_spec_flag_installs():
    pt.flags.set_flags({"FLAGS_fault_spec": "poison_batch:x@7"})
    assert fault.active()
    assert any(h.name == "poison_batch:x" for h in fault.hooks())


def test_install_from_spec_kill_save_honors_persist():
    hooks = fault.install_from_spec(
        "kill_save:before_commit@every=10:persist")
    assert len(hooks) == 1 and not hooks[0].once
    hooks = fault.install_from_spec("kill_save:before_commit@11")
    assert hooks[0].once


def test_install_from_spec_replaces_not_accumulates():
    fault.install_from_spec("nan_var:w@5")
    fault.install_from_spec("nan_var:w@5")
    assert len(fault.hooks()) == 1
    fault.install_from_spec("delay:0.01@every=8")
    assert {h.name for h in fault.hooks()} == {"delay_dispatch:0.01s"}
    direct = fault.poison_batch("x", fault.FaultSchedule(steps=[3]))
    fault.install_from_spec("nan_var:w@5")
    assert {h.name for h in fault.hooks()} == {"poison_batch:x",
                                               "nan_var:w"}
    with pytest.raises(ValueError):
        fault.install_from_spec("nan_var:w2@3;unknown_family:x@3")
    assert {h.name for h in fault.hooks()} == {"poison_batch:x",
                                               "nan_var:w"}
    fault.install_from_spec("")
    assert [h.name for h in fault.hooks()] == ["poison_batch:x"]
    fault.unregister(direct)
    assert not fault.active()


def test_fault_spec_flag_reset_and_clear():
    pt.flags.set_flags({"FLAGS_fault_spec": "delay:0.01@every=8"})
    pt.flags.set_flags({"FLAGS_fault_spec": "delay:0.01@every=8"})
    assert len(fault.hooks()) == 1
    pt.flags.set_flags({"FLAGS_fault_spec": ""})
    assert not fault.active()


def test_rejected_flag_value_not_committed():
    pt.flags.set_flags({"FLAGS_fault_spec": "delay:0.01@every=8"})
    with pytest.raises(ValueError):
        pt.flags.set_flags({"FLAGS_fault_spec": "nan_var:w@x"})
    assert pt.flags.get_flags("FLAGS_fault_spec")[
        "FLAGS_fault_spec"] == "delay:0.01@every=8"
    assert {h.name for h in fault.hooks()} == {"delay_dispatch:0.01s"}
    with pytest.raises(ValueError):
        pt.flags.set_flags({"FLAGS_guardian_policy": "skip,rolback"})
    assert "rollback" in pt.flags.get_flags("FLAGS_guardian_policy")[
        "FLAGS_guardian_policy"]
    with pytest.raises(ValueError):
        pt.flags.set_flags({"FLAGS_guardian_spike_action": "loud"})


def test_disabled_faults_cost_one_read(monkeypatch):
    """Nothing registered: a run never calls ``fault.fire``."""
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    calls = []
    monkeypatch.setattr(fault, "fire", lambda *a, **k: calls.append(a))
    pt.Executor(pt.CPUPlace()).run(main, feed=_batches(1)[0],
                                   fetch_list=[loss], scope=scope)
    assert calls == []
