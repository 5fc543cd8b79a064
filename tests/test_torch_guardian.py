"""The port's training-run guardian (``paddle_tpu_torch/guardian.py``) and
the executor's skip guard on the CPU, mirroring ``tests/test_guardian.py``
(less its parallel-executor quarantine test, which waits for ROADMAP A7):
the skip guard keeps every state variable bit-equal on a poisoned step,
the same variables the JAX guard keeps, whether the host reads the
verdict at once or later; the Trainer's rollback drill restores a clean
TrainState and ends at the clean run's final loss (1e-4, as the JAX
test); the budgets raise typed errors; the detectors; and a guardian
that is off costs nothing observable."""

import glob
import json
import os
import warnings

import ml_dtypes  # noqa: F401  (the JAX package's guardian reads it)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import fault as jax_fault
from paddle_tpu import guardian as jax_guardian

import paddle_tpu_torch as pt
from paddle_tpu_torch import fault, guardian, monitor
from paddle_tpu_torch.contrib import CheckpointConfig, Trainer
from paddle_tpu_torch.parallel import checkpoint as ck
from paddle_tpu_torch.reader import checkpointable

from test_torch_serving import fresh_torch_programs  # noqa: F401

CPU = pt.CPUPlace()


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
    pt.flags.set_flags({"guardian": False,
                        "guardian_policy": "skip,rollback,abort"})
    monitor.reset_for_tests()


def _build_mlp(pkg=pt, seed=7, decay=False):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        h = pkg.layers.dropout(h, dropout_prob=0.3)
        pred = pkg.layers.fc(h, size=4, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        lr = pkg.layers.exponential_decay(1e-2, 2, 0.5) if decay else 1e-2
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _batches(n, bs=4):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(bs, 8).astype("float32"),
             "label": rng.randint(0, 4, (bs, 1)).astype("int64")}
            for _ in range(n)]


def _state(scope, program):
    return {v.name: np.array(scope.find_var(v.name), copy=True)
            if not isinstance(scope.find_var(v.name), torch.Tensor)
            else scope.find_var(v.name).clone().numpy()
            for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def test_disabled_guardian_records_nothing_and_adds_no_fetch(monkeypatch):
    assert guardian.active() is None
    assert not guardian.skip_guard_enabled()
    monitor.enable()
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    exe = pt.Executor(CPU)
    outs = exe.run(main, feed=_batches(1)[0], fetch_list=[loss],
                   scope=scope)
    assert len(outs) == 1 and not exe._guards
    assert all(not m.startswith("guardian") for m in
               monitor.registry().expose_text().splitlines())


def _skip_run(tmp_path, return_numpy, steps=12, poison_step=5):
    pt.flags.set_flags({"guardian": True})
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    g = guardian.install(guardian.Guardian(
        quarantine_dir=str(tmp_path / ("q_%s" % return_numpy))))
    fault.poison_batch("x", fault.FaultSchedule(steps=[poison_step]))
    exe = pt.Executor(CPU)
    outs = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                    return_numpy=return_numpy)[0] for f in _batches(steps)]
    g.flush()
    stats = g.stats()
    guardian.uninstall()
    fault.clear()
    return [np.asarray(o, "float32").tobytes() for o in outs], stats


def test_skip_recovery_bit_identical_sync_vs_async(tmp_path):
    """The skip happens inside the step, so when the host reads the
    verdict cannot change the state: the losses are bit-equal whether
    the fetches come back as numpy or as tensors."""
    sync_losses, sync_stats = _skip_run(tmp_path, True)
    async_losses, async_stats = _skip_run(tmp_path, False)
    assert sync_losses == async_losses
    assert not np.isfinite(np.frombuffer(sync_losses[5], "float32")).all()
    for later in sync_losses[6:]:
        assert np.isfinite(np.frombuffer(later, "float32")).all()
    assert sync_stats["skipped_steps"] == async_stats["skipped_steps"] == 1


def test_skip_suppresses_update_and_quarantines(tmp_path):
    pt.flags.set_flags({"guardian": True})
    main, startup, loss = _build_mlp(decay=True)
    scope = pt.Scope()
    qdir = str(tmp_path / "quarantine")
    pt.Executor(CPU).run(startup, scope=scope)
    guardian.install(guardian.Guardian(quarantine_dir=qdir))
    fault.poison_batch("x", fault.FaultSchedule(steps=[1]))
    exe = pt.Executor(CPU)
    feeds = _batches(3)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    before = _state(scope, main)
    assert "@LR_DECAY_COUNTER@" in before
    (lv,) = exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
    assert not np.isfinite(lv).all()
    after = _state(scope, main)
    for n in before:     # every state var, the LR counter included
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    (lv2,) = exe.run(main, feed=feeds[2], fetch_list=[loss], scope=scope)
    assert np.isfinite(lv2).all()
    sidecars = glob.glob(os.path.join(qdir, "*.json"))
    assert len(sidecars) == 1
    rec = json.load(open(sidecars[0]))
    assert rec["run_id"] == monitor.run_id() and rec["step"] == 1
    assert rec["reason"] == "nonfinite_in_graph"
    sig = {n: (tuple(s), d) for n, s, d in rec["feed_signature"]}
    assert sig["x"] == ((4, 8), "float32")
    with np.load(rec["path"]) as z:
        arrs = {n: z["arr_%d" % i] for i, n in enumerate(rec["feed_names"])}
    assert not np.isfinite(arrs["x"]).any()


def test_skip_guard_keeps_what_the_jax_guard_keeps():
    """Both packages' guards on a poisoned step: the port leaves every
    state variable bit-equal, the JAX package every one too, so the two
    keep the same set; and the step after runs on in both."""
    kept = {}
    for pkg, fmod, gmod in ((pt, fault, guardian),
                            (fluid, jax_fault, jax_guardian)):
        pkg.set_flags({"FLAGS_guardian": True}) if pkg is fluid else \
            pt.flags.set_flags({"guardian": True})
        try:
            main, startup, loss = _build_mlp(pkg, decay=True)
            scope = pkg.Scope()
            pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
            gmod.install(gmod.Guardian(policy="skip,rollback,abort"))
            fmod.poison_batch("x", fmod.FaultSchedule(steps=[1]))
            exe = pkg.Executor(pkg.CPUPlace())
            feeds = _batches(3)
            exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
            before = _state(scope, main)
            exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
            after = _state(scope, main)
            kept[pkg.__name__] = sorted(
                n for n in before if np.array_equal(
                    np.asarray(after[n]).view(np.uint8),
                    np.asarray(before[n]).view(np.uint8)))
            assert kept[pkg.__name__] == sorted(before)
            (lv,) = exe.run(main, feed=feeds[2], fetch_list=[loss],
                            scope=scope)
            assert np.isfinite(np.asarray(lv)).all()
        finally:
            gmod.uninstall()
            fmod.clear()
            if pkg is fluid:
                fluid.set_flags({"FLAGS_guardian": False})
    assert kept["paddle_tpu_torch"] == kept["paddle_tpu"]


def test_skip_budget_exhaustion_aborts_typed_without_rollback_rung():
    pt.flags.set_flags({"guardian": True})
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    guardian.install(guardian.Guardian(policy="skip,abort", max_skips=2))
    fault.poison_batch("x", fault.FaultSchedule(every=1, start=1))
    exe = pt.Executor(CPU)
    with pytest.raises(guardian.GuardianAbortError, match="skip budget"):
        for feed in _batches(8):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def _samples(n=64):
    def samples():
        rng = np.random.RandomState(0)
        for _ in range(n):
            x = rng.rand(8).astype("float32")
            yield x, np.array([int(np.argmax(x[:4]))], "int64")
    return samples


def _mlp_train_func(pkg):
    def train_func():
        pkg.default_main_program().random_seed = 7
        pkg.default_startup_program().random_seed = 7
        x = pkg.layers.data("x", shape=[8])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=4, act="softmax")
        return pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    return train_func


def _trainer_run(ckpt_dir, inject_step=None, persist=False,
                 max_rollbacks=2, log_dir=None):
    fault.clear()
    fault.clear_injections()
    if log_dir:
        monitor.enable(log_dir=log_dir)
    if inject_step is not None:
        fault.inject_nan("fc_0.w_0", fault.FaultSchedule(steps=[inject_step]),
                         once=not persist)
    losses = []

    def handler(ev):
        if hasattr(ev, "metrics"):
            losses.append(float(np.ravel(ev.metrics[0])[0]))

    trainer = Trainer(
        train_func=_mlp_train_func(pt), place=CPU,
        optimizer_func=lambda: pt.optimizer.Adam(1e-2),
        checkpoint_config=CheckpointConfig(
            checkpoint_dir=str(ckpt_dir), step_interval=3,
            async_save=False),
        guardian_config={"policy": "rollback,abort",
                         "max_rollbacks": max_rollbacks})
    try:
        trainer.train(num_epochs=1, event_handler=handler,
                      reader=checkpointable(pt.batch(_samples(), 4)),
                      feed_order=["x", "label"])
    finally:
        if log_dir:
            monitor.disable()
    return losses


def test_rollback_drill_recovers_to_clean_final_loss(tmp_path):
    """NaN in a weight at step 6: the guardian rolls back past the
    poisoned step-7 artifact to step 4, the replay is exact, and the run
    ends at the clean run's final loss (rtol 1e-4; here bit for bit).
    The decision trail reaches the JSONL and the counters."""
    ref = _trainer_run(tmp_path / "ref_ckpt")
    log_dir = str(tmp_path / "monitor")
    drilled = _trainer_run(tmp_path / "ckpt", inject_step=6,
                           log_dir=log_dir)
    assert np.isfinite(drilled[-1])
    np.testing.assert_allclose(drilled[-1], ref[-1], rtol=1e-4)
    assert len(drilled) > len(ref)
    assert drilled[-3:] == ref[-3:]
    events = []
    for path in glob.glob(os.path.join(log_dir, "*.jsonl")):
        with open(path) as f:
            events += [json.loads(ln) for ln in f if ln.strip()]
    by_kind = {}
    for e in events:
        by_kind.setdefault(e.get("event"), []).append(e)
    assert "fault_injected" in by_kind and "guardian_nonfinite" in by_kind
    rollbacks = by_kind["guardian_rollback"]
    assert len(rollbacks) == 1
    assert rollbacks[0]["restored_step"] == 4 and rollbacks[0]["step"] == 7
    assert rollbacks[0]["run_id"] == monitor.run_id()
    assert any(e["reason"] == "nonfinite_state"
               for e in by_kind.get("guardian_checkpoint_skipped", []))
    assert monitor.registry().get("guardian/rollbacks").value == 1
    assert monitor.registry().get("fault/injections").value >= 1


def test_rollback_budget_exhausted_raises_typed_error(tmp_path):
    with pytest.raises(guardian.GuardianAbortError, match="rollback budget"):
        _trainer_run(tmp_path / "ckpt", inject_step=6, persist=True,
                     max_rollbacks=1)


def test_rollback_without_checkpoint_config_aborts():
    fault.inject_nan("fc_0.w_0", fault.FaultSchedule(steps=[2]))
    trainer = Trainer(train_func=_mlp_train_func(pt), place=CPU,
                      optimizer_func=lambda: pt.optimizer.SGD(0.1),
                      guardian_config={"policy": "rollback,abort"})
    with pytest.raises(guardian.GuardianAbortError,
                       match="no CheckpointConfig"):
        trainer.train(num_epochs=1, event_handler=lambda ev: None,
                      reader=checkpointable(pt.batch(_samples(32), 4)),
                      feed_order=["x", "label"])


def test_trainer_quarantine_default_applies_to_guardian_instance(tmp_path):
    def train_func():
        x = pt.layers.data("x", shape=[4])
        return pt.layers.mean(pt.layers.fc(x, size=1))

    g = guardian.Guardian(policy="rollback,abort")
    assert not g.quarantine_dir
    g._rollbacks = 5
    trainer = Trainer(train_func=train_func, place=CPU,
                      optimizer_func=lambda: pt.optimizer.SGD(0.1),
                      checkpoint_config=CheckpointConfig(
                          checkpoint_dir=str(tmp_path / "ckpt")),
                      guardian_config=g)
    assert trainer._make_guardian() is g
    assert g.quarantine_dir == os.path.join(str(tmp_path), "ckpt",
                                            "quarantine")
    assert g._rollbacks == 0


def _feed_losses(g, values, start=0):
    for i, v in enumerate(values):
        g.note_step("test", start + i, fetch_names=("loss",),
                    fetches=(torch.tensor(np.float32(v)),), sync=True)


def test_spike_detector_median_mad():
    monitor.enable()
    g = guardian.Guardian(policy="skip", window=16, zmax=6.0,
                          spike_action="warn")
    rng = np.random.RandomState(3)
    _feed_losses(g, 1.0 + 0.01 * rng.randn(12))
    assert monitor.registry().get("guardian/loss_spikes") is None
    _feed_losses(g, [9.0], start=12)
    assert monitor.registry().get("guardian/loss_spikes").value == 1
    assert max(g.stats()["window"]) < 2.0
    g2 = guardian.Guardian(policy="skip,rollback", window=16, zmax=6.0,
                           spike_action="rollback")
    _feed_losses(g2, 1.0 + 0.01 * rng.randn(12))
    with pytest.raises(guardian.GuardianRollback, match="spike"):
        _feed_losses(g2, [9.0], start=12)


def test_spike_detector_one_sided_and_bounded():
    monitor.enable()
    g = guardian.Guardian(policy="skip", window=16, zmax=6.0,
                          spike_action="warn")
    rng = np.random.RandomState(5)
    _feed_losses(g, 2.0 + 0.01 * rng.randn(16))
    _feed_losses(g, 1.4 + 0.01 * rng.randn(4), start=16)
    assert monitor.registry().get("guardian/loss_spikes") is None
    assert min(g.stats()["window"]) < 1.5
    g2 = guardian.Guardian(policy="skip", window=16, zmax=6.0,
                           spike_action="warn")
    _feed_losses(g2, 1.0 + 0.01 * rng.randn(16))
    _feed_losses(g2, 3.0 + 0.01 * rng.randn(40), start=16)
    flagged = monitor.registry().get("guardian/loss_spikes").value
    assert 0 < flagged <= 16 // 2 + 1
    assert float(np.median(g2.stats()["window"])) > 2.5


def test_plateau_detector_fires_once():
    monitor.enable()
    g = guardian.Guardian(policy="skip", plateau_steps=8, zmax=0)
    _feed_losses(g, [1.0] * 20)
    c = monitor.registry().get("guardian/plateaus")
    assert c is not None and c.value == 1


def test_plateau_window_longer_than_spike_window_fires():
    monitor.enable()
    g = guardian.Guardian(policy="skip", window=8, plateau_steps=24, zmax=0)
    _feed_losses(g, [1.0] * 30)
    c = monitor.registry().get("guardian/plateaus")
    assert c is not None and c.value == 1


def test_stall_escalation_arms_typed_abort():
    g = guardian.Guardian(policy="skip", stall_escalations=2)
    guardian.install(g)
    diag = {"stalled_for_s": 120.0, "stall_seconds": 120.0}
    g._on_stall(diag)
    g._on_stall(diag)
    with pytest.raises(guardian.GuardianAbortError, match="wedged"):
        g.note_step("test", 0, fetch_names=(), fetches=(), sync=True)
    g2 = guardian.Guardian(policy="skip", stall_escalations=2)
    g2._on_stall(diag)
    g2.note_step("test", 0, fetch_names=(), fetches=(), sync=True)
    g2._on_stall(diag)
    g2.note_step("test", 1, fetch_names=(), fetches=(), sync=True)


def test_rollback_restore_skips_poisoned_and_corrupt_artifacts(tmp_path):
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    exe = pt.Executor(CPU)
    mgr = ck.TrainStateCheckpointManager(str(tmp_path), async_save=False)
    feeds = _batches(3)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    mgr.save(1, scope=scope, program=main, executors={"train": exe})
    exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
    mgr.save(2, scope=scope, program=main, executors={"train": exe})
    scope.set_var("fc_0.w_0", torch.full_like(scope.find_var("fc_0.w_0"),
                                              float("nan")))
    mgr.save(3, scope=scope, program=main, executors={"train": exe})
    with open(os.path.join(str(tmp_path), "step_%010d" % 2, "arrays.npz"),
              "r+b") as f:
        f.seek(16)
        f.write(b"\xff" * 32)
    g = guardian.Guardian(policy="rollback,abort")
    rb = guardian.GuardianRollback(9, "drill", quarantined=False)
    restored = g.rollback_restore(mgr, rb, scope=scope, program=main,
                                  executors={"train": exe})
    assert restored == 1 and g.last_replay_steps == 8
    assert torch.isfinite(scope.find_var("fc_0.w_0")).all()
    assert exe.state_dict()["run_counter"] == 1
    assert g.post_restore(rb, restored) == 0
    rb_q = guardian.GuardianRollback(9, "drill", quarantined=True)
    assert g.post_restore(rb_q, restored) == 9


def test_rollback_abort_leaves_live_state_untouched(tmp_path):
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    exe = pt.Executor(CPU)
    mgr = ck.TrainStateCheckpointManager(str(tmp_path), async_save=False)
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    w = scope.find_var("fc_0.w_0")
    scope.set_var("fc_0.w_0", torch.full_like(w, float("nan")))
    mgr.save(1, scope=scope, program=main, executors={"train": exe})
    w_live = torch.zeros_like(w)
    scope.set_var("fc_0.w_0", w_live.clone())
    mgr._last_saved = None
    g = guardian.Guardian(policy="rollback,abort")
    rb = guardian.GuardianRollback(5, "drill", quarantined=False)
    with pytest.raises(guardian.GuardianAbortError, match="no clean"):
        g.rollback_restore(mgr, rb, scope=scope, program=main,
                           executors={"train": exe})
    assert torch.equal(scope.find_var("fc_0.w_0"), w_live)
    assert mgr._last_saved is None


def test_unobserved_skip_guard_warns_once():
    pt.flags.set_flags({"guardian": True})
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    exe = pt.Executor(CPU)
    feeds = _batches(2)
    with pytest.warns(UserWarning, match="no guardian is installed"):
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
    assert not [w for w in rec if "no guardian" in str(w.message)]


def test_rollback_with_unrewindable_reader_warns(tmp_path):
    fault.inject_nan("fc_0.w_0", fault.FaultSchedule(steps=[4]))
    trainer = Trainer(train_func=_mlp_train_func(pt), place=CPU,
                      optimizer_func=lambda: pt.optimizer.SGD(0.1),
                      checkpoint_config=CheckpointConfig(
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          step_interval=2, async_save=False),
                      guardian_config={"policy": "rollback,abort"})
    with pytest.warns(UserWarning, match="cannot rewind"):
        trainer.train(num_epochs=1, event_handler=lambda ev: None,
                      reader=pt.batch(_samples(32), 4),
                      feed_order=["x", "label"])
    assert not pt.flags.get_flags("FLAGS_guardian")["FLAGS_guardian"]


def test_trainer_construction_does_not_warn_unobserved_guard():
    def train_func():
        x = pt.layers.data("x", shape=[4])
        return pt.layers.mean(pt.layers.fc(x, size=1))

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        Trainer(train_func=train_func, place=CPU,
                optimizer_func=lambda: pt.optimizer.SGD(0.1),
                guardian_config={"policy": "rollback,abort"})
    assert not [w for w in rec if "no guardian" in str(w.message)]
    assert not pt.flags.get_flags("FLAGS_guardian")["FLAGS_guardian"]


def test_restore_clears_pending_fast_forward_debt():
    r = checkpointable(lambda: iter(range(10)))
    r.fast_forward(4)
    r.load_state_dict({"epoch": 0, "offset": 2})
    assert list(r()) == list(range(2, 10))


def test_fast_forward_carries_across_epoch_boundary():
    r = checkpointable(lambda: iter(range(10)))
    r.load_state_dict({"epoch": 0, "offset": 8})
    r.fast_forward(3)
    assert list(r()) == []
    assert list(r()) == list(range(1, 10))
    assert r.state_dict() == {"epoch": 2, "offset": 0}


def test_saturated_window_float_noise_not_a_spike():
    monitor.enable()
    g = guardian.Guardian(policy="skip", window=16, zmax=8.0,
                          spike_action="warn")
    _feed_losses(g, [2.0] * 16)
    _feed_losses(g, [2.00001], start=16)
    assert monitor.registry().get("guardian/loss_spikes") is None
    _feed_losses(g, [2.1], start=17)
    assert monitor.registry().get("guardian/loss_spikes").value == 1


def test_invalid_guardian_config_does_not_leak_flag():
    def train_func():
        x = pt.layers.data("x", shape=[4])
        return pt.layers.mean(pt.layers.fc(x, size=1))

    def samples():
        yield (np.zeros(4, "float32"),)

    trainer = Trainer(train_func=train_func, place=CPU,
                      optimizer_func=lambda: pt.optimizer.SGD(0.1),
                      guardian_config={"policy": "rollbak,abort"})
    with pytest.raises(ValueError, match="policy"):
        trainer.train(num_epochs=1, event_handler=lambda ev: None,
                      reader=checkpointable(pt.batch(samples, 1)),
                      feed_order=["x"])
    assert not pt.flags.get_flags("FLAGS_guardian")["FLAGS_guardian"]


def test_guardian_instance_reset_between_runs():
    g = guardian.Guardian(policy="rollback,abort", max_rollbacks=1)
    rb = guardian.GuardianRollback(3, "drill")
    g.begin_rollback(rb)
    with pytest.raises(guardian.GuardianAbortError, match="budget"):
        g.begin_rollback(rb)
    g.reset_run_state()
    g.begin_rollback(rb)


def test_finite_scan_covers_torch_dtypes():
    """The poisoned-checkpoint scan sees NaNs in bfloat16 and float8
    state, and integral state is always finite."""
    assert guardian._finite(torch.tensor([1, 2], dtype=torch.int32))
    nan32 = torch.tensor([1.0, float("nan")])
    assert not guardian._finite(nan32)
    assert not guardian._finite(nan32.to(torch.bfloat16))
    assert not guardian._finite(nan32.to(torch.float8_e5m2))
    assert guardian._finite(torch.tensor([1.0, 2.0]).to(torch.bfloat16))
    assert not guardian._finite(np.array([np.inf], np.float32))


def test_skip_guard_on_the_transformer_step():
    """The Transformer training step (2+2 layers, dropout 0.1, noam and
    Adam) with its ``tgt_word@LEN`` filled with 0 by ``poison_batch``: no
    target token, so the loss is 0/0; the guard leaves every state
    variable (the noam step counter included) bit-equal, and the clean
    step after it equals a run that skipped the poisoned step by hand
    (ran it, then put the state back: the generator advanced alike)."""
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, 8, 8, 20, 20, dropout_rate=0.1, n_layer=2, n_head=2,
            d_model=32, d_inner=64)
        pt.optimizer.Adam(learning_rate=pt.layers.noam_decay(32, 10),
                          beta1=0.9, beta2=0.997,
                          epsilon=1e-9).minimize(cost)
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(4):
        lens = rng.randint(3, 9, 4).astype("int32")
        f = {n: rng.randint(0, 20, (4, 8, 1)).astype("int64")
             for n in ("src_word", "tgt_word", "lbl_word")}
        f.update({n + "@LEN": lens for n in ("src_word", "tgt_word",
                                             "lbl_word")})
        feeds.append(f)
    runs = {}
    for arm in ("guard", "reference"):
        pt.flags.set_flags({"guardian": arm == "guard"})
        scope = pt.Scope()
        pt.Executor(CPU).run(startup, scope=scope)
        g = guardian.install(guardian.Guardian(policy="skip,abort")) \
            if arm == "guard" else None
        exe = pt.Executor(CPU)
        losses = [exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0]
                  for f in feeds[:2]]
        before = _state(scope, main)
        fault.poison_batch("tgt_word@LEN", fault.FaultSchedule(steps=[2]),
                           fill=0)
        (bad,) = exe.run(main, feed=feeds[2], fetch_list=[cost],
                         scope=scope)
        fault.clear()
        assert not np.isfinite(bad).all()
        after = _state(scope, main)
        changed = [n for n in before
                   if not np.array_equal(before[n], after[n])]
        if arm == "guard":
            assert changed == [] and g.stats()["skipped_steps"] == 1
            guardian.uninstall()
        else:
            assert changed
            for n, v in before.items():
                scope.set_var(n, torch.from_numpy(v.copy()))
        losses.append(exe.run(main, feed=feeds[3], fetch_list=[cost],
                              scope=scope)[0])
        runs[arm] = ([x.tobytes() for x in losses], _state(scope, main))
    assert runs["guard"][0] == runs["reference"][0]
    for n, v in runs["guard"][1].items():
        np.testing.assert_array_equal(v, runs["reference"][1][n], err_msg=n)
