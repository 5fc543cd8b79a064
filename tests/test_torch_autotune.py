"""The port's tuner (``paddle_tpu_torch/autotune.py``) on the CPU: the
counterparts of ``tests/test_autotune.py`` (all but the pipeline-bound
ones), of the tuner tests of ``tests/test_quantize_inference.py`` and
``tests/test_paged_kv.py``, and the cross-package cases: every pure
decision equal to the JAX function's on seeded draws, TunedConfig
artifacts and decision tables crossing both ways, the Trainer's interval
and events, and ``tools/autotune_report.py`` rendering both packages'
artifacts alike.  On the CPU every op runs its plain version, so the
ladder has no measured peak and the A/Bs time two equal arms: these tests
check rungs, windows, analyses, tables and outcomes.  The ``cuda`` cases
(the ladder under a fake memory limit, re-capture on a changed ruling)
run on the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import autotune as jax_at
from paddle_tpu import flags as jax_flags

import paddle_tpu_torch as pt
from paddle_tpu_torch import autotune, compile_cache, flags, monitor
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.monitor import program_profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PINS = ("autotune_hbm_bytes", "autotune_dir", "quantize_mode",
         "compile_cache_dir", "preflight_hbm_bytes")


@pytest.fixture(autouse=True)
def fresh_autotune_state():
    """Fresh port programs, scope and name counter; empty kernel tables
    and entry cache; the tuner's flags back at their defaults with their
    pins as they were; the JAX package's tables too."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    pins = {n: flags.pinned(n) for n in _PINS}
    jax_pins = {n: jax_flags.pinned(n) for n in (
        "pallas_kernels", "autotune_dir", "quantize_mode")}
    for mod in (autotune, jax_at):
        mod.reset_attention_table()
        mod.reset_quant_kernel_table()
    compile_cache.clear()
    program_profile.reset()
    with pt.scope_guard(pt.Scope()):
        yield
    flags.set_flags({"autotune_hbm_bytes": 0, "autotune_dir": "",
                     "quantize_mode": "", "compile_cache_dir": "",
                     "preflight_hbm_bytes": 0}, pin=False)
    flags._restore_pins(pins)
    jax_flags.set_flags({"autotune_dir": "", "quantize_mode": "",
                         "pallas_kernels": False}, pin=False)
    jax_flags._restore_pins(jax_pins)
    for mod in (autotune, jax_at):
        mod.reset_attention_table()
        mod.reset_quant_kernel_table()
    program_profile.reset()
    monitor.reset_for_tests()
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


CPU = pt.CPUPlace()


# ---------------------------------------------------------------------------
# batch-size ladder (pure)
# ---------------------------------------------------------------------------

def test_batch_ladder_geometric():
    assert autotune.batch_ladder(32, 256) == [32, 64, 128, 256]
    assert autotune.batch_ladder(48, 100) == [48, 96]


def test_ladder_stops_at_projected_hbm_ceiling():
    probed, measured = [], []

    def probe(b):
        probed.append(b)
        return 1000 * b

    def measure(b):
        measured.append(b)
        return 0.001 * b ** 0.9

    d = autotune.run_batch_ladder([16, 32, 64, 128], hbm_limit=70000,
                                  probe_fn=probe, measure_fn=measure,
                                  headroom=0.9)
    assert probed == [16, 32] and measured == [16, 32]
    assert d["chosen"] == 32
    last = d["candidates"][-1]
    assert last["status"] == "rejected_projected_hbm"
    assert last["batch"] == 64
    assert last["projected_peak_hbm_bytes"] == pytest.approx(64000,
                                                             rel=.01)
    assert "step_s" not in last


def test_ladder_rejects_probed_peak_before_any_dispatch():
    measured = []
    peaks = {16: 10_000, 32: 80_000}
    d = autotune.run_batch_ladder(
        [16, 32], hbm_limit=70_000, probe_fn=lambda b: peaks[b],
        measure_fn=lambda b: measured.append(b) or 0.0001 * b,
        headroom=1.0)
    assert measured == [16]
    assert d["candidates"][-1]["status"] == "rejected_hbm"
    assert d["chosen"] == 16


def test_ladder_throughput_regression_stop():
    spe = {16: 10.0, 32: 6.0, 64: 4.0, 128: 4.1, 256: 6.0, 512: 9.9}
    d = autotune.run_batch_ladder(
        sorted(spe), hbm_limit=None, probe_fn=lambda b: None,
        measure_fn=lambda b: spe[b] * b, regress_tol=0.05)
    assert d["chosen"] == 64
    assert [c["status"] for c in d["candidates"]] == \
        ["ok", "ok", "ok", "ok", "regressed"]
    assert d["candidates"][-1]["batch"] == 256


def test_ladder_no_limit_measures_every_rung():
    d = autotune.run_batch_ladder(
        [8, 16], hbm_limit=None, probe_fn=lambda b: 100 * b,
        measure_fn=lambda b: 0.001 * b)
    assert [c["status"] for c in d["candidates"]] == ["ok", "ok"]
    assert d["chosen"] == 8
    assert d["hbm_limit_bytes"] is None


# ---------------------------------------------------------------------------
# attention kernel + bucket bounds (pure)
# ---------------------------------------------------------------------------

def test_decide_attention_kernel_thresholds():
    assert autotune.decide_attention_kernel(0.010, 0.006)["pallas"]
    assert not autotune.decide_attention_kernel(0.010, 0.010)["pallas"]
    assert not autotune.decide_attention_kernel(0.010, 0.0099)["pallas"]
    d = autotune.decide_attention_kernel(0.012, 0.004, min_speedup=1.1)
    assert d["pallas"] and d["speedup"] == pytest.approx(3.0)


def _wmt16_like_lengths():
    rng = np.random.RandomState(7)
    return np.clip(rng.lognormal(3.2, 0.55, size=4000), 4,
                   64).astype(int).tolist()


def test_token_fill_and_4_not_6_outcome():
    lengths = _wmt16_like_lengths()
    friendly = [16, 32, 48, 64]
    ragged6 = [12, 20, 28, 36, 48, 64]
    assert autotune.token_fill(lengths, ragged6) > \
        autotune.token_fill(lengths, friendly)
    d = autotune.choose_bucket_bounds(lengths, k=6, multiple=16)
    assert d["chosen"] == friendly
    assert d["fill"] == pytest.approx(
        autotune.token_fill(lengths, friendly), abs=1e-3)
    assert d["fill"] > 1.5 * d["pad_to_max_fill"]


def test_choose_bucket_bounds_k_subsets():
    d = autotune.choose_bucket_bounds({14: 100, 16: 100, 60: 10, 64: 10},
                                      k=2, multiple=16)
    assert d["chosen"] == [16, 64]
    d = autotune.choose_bucket_bounds({5: 3, 33: 1}, k=1, multiple=16)
    assert d["chosen"] == [48]


# ---------------------------------------------------------------------------
# checkpoint interval (pure)
# ---------------------------------------------------------------------------

def test_checkpoint_interval_monotone_in_save_cost():
    prev = 0
    for save_s in (0.01, 0.1, 0.5, 2.0, 5.0):
        d = autotune.decide_checkpoint_interval(
            step_s=0.1, snapshot_s=0.01, save_s=save_s, budget=0.035)
        assert d["chosen"] >= prev
        prev = d["chosen"]
    prev = 0
    for snap_s in (0.001, 0.01, 0.05, 0.2):
        d = autotune.decide_checkpoint_interval(
            step_s=0.1, snapshot_s=snap_s, save_s=0.0, budget=0.035)
        assert d["chosen"] >= prev
        assert d["overhead_frac"] <= 0.035 + 1e-9
        prev = d["chosen"]


def test_checkpoint_interval_drain_and_sync_modes():
    d = autotune.decide_checkpoint_interval(
        step_s=0.1, snapshot_s=0.001, save_s=2.0, budget=0.035)
    assert d["chosen"] == 20 and d["drain_bound_steps"] == 20
    d_sync = autotune.decide_checkpoint_interval(
        step_s=0.1, snapshot_s=0.001, save_s=2.0, budget=0.035,
        async_save=False)
    assert d_sync["chosen"] > 500
    assert d_sync["overhead_frac"] <= 0.035 + 1e-9
    with pytest.raises(ValueError):
        autotune.decide_checkpoint_interval(0.0, 0.01, 0.01)


# ---------------------------------------------------------------------------
# TunedConfig artifact + pins
# ---------------------------------------------------------------------------

def test_tuned_config_round_trip(tmp_path):
    cfg = autotune.TunedConfig(meta={"model": "t"})
    cfg.add({"knob": "batch_size", "chosen": 512,
             "candidates": [{"batch": 512, "status": "ok"}]},
            fingerprint="abcdef012345")
    cfg.add(autotune.decide_checkpoint_interval(0.02, 0.002, 0.01))
    path = cfg.save(str(tmp_path / "tuned.json"))
    loaded = autotune.TunedConfig.load(path)
    assert loaded.value("batch_size") == 512
    assert loaded.value("checkpoint_interval") == cfg.value(
        "checkpoint_interval")
    assert loaded.meta["model"] == "t"
    assert loaded.get("batch_size")["fingerprint"] == "abcdef012345"
    loaded.add({"knob": "batch_size", "chosen": 256})
    assert loaded.value("batch_size") == 256
    doc = json.loads(open(path).read())
    assert doc["meta"]["version"] == autotune.TunedConfig.VERSION


def test_pins_and_rulings_in_apply():
    """The port has no kernel-selecting flag: a kernel ruling always
    applies; a pinned ``FLAGS_quantize_mode`` wins over a quantization
    ruling (the JAX package's ``pallas_kernels`` pin, for the knob the
    port pins)."""
    q = k = (2, 2, 32, 16)
    key = autotune.attention_shape_key(q, k, "float32")
    cfg = autotune.TunedConfig(decisions=[
        {"knob": "attention_kernel", "shape": key, "pallas": False},
        {"knob": "quantization", "chosen": "dynamic"}])
    assert autotune.attention_choice(q, k, torch.float32) is None
    assert cfg.apply() == [("attention_kernel", "applied"),
                           ("quantization", "advisory")]
    assert autotune.attention_choice(q, k, torch.float32) is False
    flags.set_flags({"FLAGS_quantize_mode": "off"})        # pin=True
    assert flags.pinned("quantize_mode")
    assert ("quantization", "pinned") in cfg.apply()
    flags._restore_pins({"quantize_mode": False})
    assert ("quantization", "advisory") in cfg.apply()


def test_flag_pins_and_validators(monkeypatch):
    flags.set_flags({"autotune_dir": "/x"}, pin=False)
    assert not flags.pinned("autotune_dir")
    flags.set_flags({"FLAGS_autotune_dir": "/y"})
    assert flags.pinned("FLAGS_autotune_dir")
    assert flags.get_flags("autotune_dir") == {"autotune_dir": "/y"}
    flags._restore_pins({"autotune_dir": False})
    assert not flags.pinned("autotune_dir")
    with pytest.raises(ValueError, match="quantize_mode"):
        flags.set_flags({"quantize_mode": "int4"})
    assert flags.flag("quantize_mode") == ""
    assert flags.flag("autotune_overhead_budget") == 0.035
    assert flags.flag("quantize_accuracy_budget") == 0.02
    # a flag the environment sets at registration is pinned
    monkeypatch.setenv("FLAGS_ptt_probe_flag", "3")
    flags.register_flag("ptt_probe_flag", 0, int)
    assert flags.flag("ptt_probe_flag") == 3 and flags.pinned(
        "ptt_probe_flag")


def test_attention_table_persists_and_rekeys_traces(tmp_path):
    flags.set_flags({"FLAGS_autotune_dir": str(tmp_path)}, pin=False)
    t0 = compile_cache.trace_flag_values()
    key = autotune.attention_shape_key((1, 1, 64, 16), (1, 1, 64, 16),
                                       "float32")
    autotune.attention_table().record("fp1", key, True)
    assert compile_cache.trace_flag_values() != t0
    assert os.path.exists(
        str(tmp_path / autotune.AttentionDecisionTable.FILENAME))
    autotune.reset_attention_table()
    e = autotune.attention_table().lookup("fp1", key)
    assert e is not None and e["pallas"] is True
    assert autotune.attention_table().lookup("other", key)["pallas"]
    autotune.reset_attention_table()
    assert autotune.attention_choice((1, 1, 64, 16), (1, 1, 64, 16),
                                     torch.float32) is True


def test_forced_arm_keys_the_trace_and_wins():
    key = autotune.attention_shape_key((1, 1, 8, 16), (1, 1, 8, 16),
                                       "float32")
    autotune.attention_table().record("", key, True, persist=False)
    tok = autotune.trace_token()
    with autotune._forced_arm("attention", key, False):
        assert autotune.attention_choice((1, 1, 8, 16), (1, 1, 8, 16),
                                         "float32") is False
        assert autotune.trace_token() != tok
    assert autotune.trace_token() == tok
    assert autotune.attention_choice((1, 1, 8, 16), (1, 1, 8, 16),
                                     "float32") is True


def test_shape_keys_spell_like_jax():
    for q, k, dt in (((2, 8, 256, 64), (2, 8, 256, 64), "float32"),
                     ((8, 8, 1, 64), (8, 8, 1024, 64), "bfloat16")):
        torch_dt = getattr(torch, dt)
        assert autotune.attention_shape_key(q, k, torch_dt) == \
            jax_at.attention_shape_key(q, k, dt)
    assert autotune.quant_shape_key(8, 512, 32000, torch.float32,
                                    "dynamic") == \
        jax_at.quant_shape_key(8, 512, 32000, np.float32, "dynamic")


def test_hbm_ceiling_order():
    assert autotune.hbm_ceiling("cpu") is None
    flags.set_flags({"preflight_hbm_bytes": 5000}, pin=False)
    assert autotune.hbm_ceiling("cpu") == 5000
    flags.set_flags({"autotune_hbm_bytes": 7000}, pin=False)
    assert autotune.hbm_ceiling("cpu") == 7000


# ---------------------------------------------------------------------------
# probe accounting
# ---------------------------------------------------------------------------

def test_probe_accounting_excluded_from_report():
    with program_profile.probe_accounting():
        assert program_profile.probe_active()
        program_profile.note_step("probefp", 5.0, 32)
    program_profile.note_step("steadyfp", 1.0, 32)
    rows = {(r["fingerprint"], bool(r.get("probe"))): r
            for r in program_profile.report_rows() if r["steps"]}
    assert rows[("probefp", True)]["wall_share"] == 0.0
    assert rows[("probefp", True)]["mfu"] is None
    assert rows[("steadyfp", False)]["wall_share"] == 1.0
    assert "probe:" in program_profile.render_table(
        program_profile.report_rows())


def test_probe_work_never_blends_into_steady_row():
    with program_profile.probe_accounting():
        for _ in range(5):
            program_profile.note_step("fp", 2.0, 8)
    program_profile.note_step("fp", 1.0, 8)
    rows = [r for r in program_profile.report_rows() if r["steps"]]
    assert len(rows) == 2
    steady = next(r for r in rows if not r.get("probe"))
    probe = next(r for r in rows if r.get("probe"))
    assert steady["fingerprint"] == probe["fingerprint"] == "fp"
    assert steady["steps"] == 1 and steady["wall_s"] == 1.0
    assert steady["wall_share"] == 1.0
    assert probe["steps"] == 5 and probe["wall_s"] == 10.0
    assert probe["wall_share"] == 0.0 and probe["mfu"] is None


# ---------------------------------------------------------------------------
# the tuner loops on the CPU (plain versions)
# ---------------------------------------------------------------------------

def _toy_mlp():
    pt.default_main_program().random_seed = 7
    pt.default_startup_program().random_seed = 7
    img = pt.layers.data("img", shape=[784])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    h = pt.layers.fc(img, size=64, act="relu")
    pred = pt.layers.fc(h, size=10, act="softmax")
    loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
    pt.optimizer.Adam(1e-3).minimize(loss)
    rng = np.random.RandomState(0)

    def make_feed(b):
        return {"img": rng.rand(b, 784).astype("float32"),
                "label": rng.randint(0, 10, (b, 1)).astype("int64")}
    return loss, make_feed


def test_tune_batch_size_rungs_windows_and_one_analysis_a_rung():
    """Every rung measured (no ceiling on the CPU), one new entry
    analyzed a rung and none by the windows; the probe's steps land in
    the probe rows; the decision lands in the config with provenance.
    A fresh executor re-measuring the chosen rung takes the analysis from
    the cache."""
    loss, make_feed = _toy_mlp()
    main, startup = pt.default_main_program(), pt.default_startup_program()
    compile_cache.reset_stats()
    cfg = autotune.TunedConfig()
    d = autotune.tune_batch_size(main, startup, make_feed, loss, CPU,
                                 start=8, max_batch=64, probe_steps=2,
                                 regress_tol=1e9, config=cfg)
    assert [c["batch"] for c in d["candidates"]] == [8, 16, 32, 64]
    assert all(c["status"] == "ok" and c["step_s"] > 0
               and c["captures"] == 0 for c in d["candidates"])
    assert d["hbm_limit_bytes"] is None and d["chosen"] in (8, 16, 32, 64)
    fp12 = compile_cache.program_fingerprint(main)[:12]
    # the startup program's entry and one a rung
    assert compile_cache.stats()["lowerings_by_program"][fp12] == 4
    assert cfg.value("batch_size") == d["chosen"]
    assert cfg.get("batch_size")["fingerprint"] == fp12
    before = compile_cache.stats()
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    autotune.measure_step_window(exe, main, make_feed(d["chosen"]), [loss],
                                 steps=2, scope=scope)
    after = compile_cache.stats()
    assert after["lowerings"] - before["lowerings"] == 0
    assert after["trace_hits"] - before["trace_hits"] == 2


def test_tune_batch_size_twice_same_statuses():
    loss, make_feed = _toy_mlp()
    kw = dict(start=8, max_batch=32, probe_steps=1, regress_tol=1e9)
    args = (pt.default_main_program(), pt.default_startup_program(),
            make_feed, loss, CPU)
    d1 = autotune.tune_batch_size(*args, **kw)
    d2 = autotune.tune_batch_size(*args, **kw)
    assert [c["status"] for c in d1["candidates"]] == \
        [c["status"] for c in d2["candidates"]]
    assert [c["batch"] for c in d2["candidates"]] == [8, 16, 32]


def test_tune_batch_size_chosen_is_its_best_rung():
    """The tuner's chosen batch is the best seconds per example among the
    rungs it measured (the JAX package's acceptance, against the
    tuner's own windows)."""
    loss, make_feed = _toy_mlp()
    d = autotune.tune_batch_size(pt.default_main_program(),
                                 pt.default_startup_program(), make_feed,
                                 loss, CPU, ladder=[8, 16, 32],
                                 probe_steps=2, regress_tol=1e9)
    ok = [c for c in d["candidates"] if c["status"] == "ok"]
    assert d["chosen"] == min(ok, key=lambda c: c["s_per_example"])["batch"]


def _attention_program(dropout=0.0, is_test=True):
    n_head, T, dh, b = 2, 16, 64, 2
    q = pt.layers.data("q", shape=[n_head, T, dh])
    k = pt.layers.data("k", shape=[n_head, T, dh])
    v = pt.layers.data("v", shape=[n_head, T, dh])
    att = pt.layers.fused_attention(q, k, v, causal=True,
                                    dropout_rate=dropout, is_test=is_test)
    loss = pt.layers.reduce_mean(att)
    rng = np.random.RandomState(0)
    feed = {n: rng.rand(b, n_head, T, dh).astype("float32") for n in "qkv"}
    shape = ((b, n_head, T, dh), (b, n_head, T, dh), "float32")
    return loss, feed, shape


def test_tune_attention_kernel_ab_and_warm_table(tmp_path):
    flags.set_flags({"FLAGS_autotune_dir": str(tmp_path)}, pin=False)
    loss, feed, shape = _attention_program()
    main, startup = pt.default_main_program(), pt.default_startup_program()
    cfg = autotune.TunedConfig()
    d = autotune.tune_attention_kernel(main, startup, feed, loss, CPU,
                                       shape=shape, probe_steps=2,
                                       config=cfg)
    assert d["xla_step_s"] > 0 and d["pallas_step_s"] > 0
    assert d["pallas"] == (
        d["xla_step_s"] / d["pallas_step_s"] >= d["min_speedup"])
    assert autotune._FORCED == {}
    # a warm process: a fresh table reads the persisted ruling, no probe
    autotune.reset_attention_table()
    monitor.enable()
    d2 = autotune.tune_attention_kernel(main, startup, feed, loss, CPU,
                                        shape=shape, probe_steps=2)
    assert d2.get("cached") and d2["pallas"] == d["pallas"]
    assert monitor.registry().get("autotune/probes") is None
    assert autotune.attention_choice(*shape) == d["pallas"]
    assert cfg.get("attention_kernel")["shape"] == d["shape"]


def test_attention_without_library_arm_records_the_kernel():
    loss, feed, shape = _attention_program(dropout=0.1, is_test=False)
    d = autotune.tune_attention_kernel(
        pt.default_main_program(), pt.default_startup_program(), feed,
        loss, CPU, shape=shape)
    assert d == {"knob": "attention_kernel", "shape": d["shape"],
                 "pallas": True, "evidence": "no_library_arm"}
    assert autotune.attention_choice(*shape) is True


def test_trainer_consumes_tuned_config(tmp_path):
    from paddle_tpu_torch.contrib import CheckpointConfig, Trainer
    from paddle_tpu_torch.reader import checkpointable

    cfg = autotune.TunedConfig()
    cfg.add(autotune.decide_checkpoint_interval(
        step_s=0.02, snapshot_s=0.002, save_s=0.01, async_save=False))
    path = cfg.save(str(tmp_path / "tuned.json"))
    expect = cfg.value("checkpoint_interval")
    assert expect and expect != 10

    def train_func():
        pt.default_main_program().random_seed = 7
        pt.default_startup_program().random_seed = 7
        x = pt.layers.data("x", shape=[8])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = pt.layers.fc(x, size=4, act="softmax")
        return pt.layers.mean(pt.layers.cross_entropy(pred, label))

    def samples():
        rng = np.random.RandomState(0)
        for _ in range(16):
            yield (rng.rand(8).astype("float32"),
                   rng.randint(0, 4, (1,)).astype("int64"))

    losses = []

    def handler(ev):
        if hasattr(ev, "metrics"):
            losses.append(float(np.ravel(ev.metrics[0])[0]))

    tr = Trainer(train_func=train_func, place=CPU,
                 optimizer_func=lambda: pt.optimizer.Adam(1e-3),
                 checkpoint_config=CheckpointConfig(
                     checkpoint_dir=str(tmp_path / "ck1"),
                     async_save=False),
                 autotune=path)
    assert tr.checkpoint_cfg.step_interval == expect
    assert tr._ckpt_mgr.save_interval_steps == expect
    tr.train(num_epochs=1, event_handler=handler,
             reader=checkpointable(pt.batch(samples, batch_size=8)),
             feed_order=["x", "label"])
    assert losses and np.isfinite(losses[-1])
    tr2 = Trainer(train_func=train_func, place=CPU,
                  optimizer_func=lambda: pt.optimizer.Adam(1e-3),
                  checkpoint_config=CheckpointConfig(
                      checkpoint_dir=str(tmp_path / "ck2"),
                      step_interval=5, async_save=False),
                  autotune=path)
    assert tr2.checkpoint_cfg.step_interval == 5
    assert tr2._ckpt_mgr.save_interval_steps == 5


def test_manager_measured_costs_and_tune(tmp_path):
    from paddle_tpu_torch.parallel.checkpoint import (
        TrainStateCheckpointManager)

    x = pt.layers.data("x", shape=[4])
    loss = pt.layers.mean(pt.layers.fc(x, size=2))
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(CPU)
    exe.run(pt.default_startup_program())
    mgr = TrainStateCheckpointManager(str(tmp_path), async_save=False)
    assert mgr.measured_costs() == {}
    mgr.save(1, program=pt.default_main_program(), executors={"train": exe})
    costs = mgr.measured_costs()
    assert costs["n"] == 1
    assert costs["snapshot_s"] > 0 and costs["save_s"] > 0
    d = autotune.tune_checkpoint_interval(step_s=0.05, manager=mgr,
                                          async_save=False)
    assert d["chosen"] >= 1 and d["measured_saves"] == 1
    mgr.set_interval(7)
    assert mgr.save_interval_steps == 7
    with pytest.raises(ValueError):
        autotune.tune_checkpoint_interval(manager=mgr)   # no step time


def test_tune_checkpoint_interval_carries_the_replay():
    class _G:
        last_replay_steps = 4
    d = autotune.tune_checkpoint_interval(step_s=0.5, snapshot_s=0.1,
                                          save_s=2.0, guardian=_G())
    assert d["last_replay_steps"] == 4 and d["last_replay_s"] == 2.0
    assert d["chosen"] == autotune.decide_checkpoint_interval(
        0.5, 0.1, 2.0)["chosen"]


def test_measure_step_window_on_the_cpu():
    loss, make_feed = _toy_mlp()
    exe = pt.Executor(CPU)
    exe.run(pt.default_startup_program())
    s = autotune.measure_step_window(exe, pt.default_main_program(),
                                     make_feed(4), [loss], steps=3)
    assert s > 0 and exe._run_counter == 1 + 1 + 3


def test_ab_arm_keeps_its_fastest_window(monkeypatch):
    """An A/B arm times ``AB_WINDOWS`` windows (the warm-up runs only in
    the first) and keeps the fastest: one window's host stall does not
    decide a ruling."""
    calls = []
    times = iter([3.0, 1.0, 2.0])

    def window(exe, program, feed, fetch_list, steps, warmup, scope):
        calls.append(warmup)
        return next(times)

    monkeypatch.setattr(autotune, "measure_step_window", window)
    assert autotune.AB_WINDOWS == 3
    assert autotune._ab_window(None, None, {}, [], 4, 1, None) == 1.0
    assert calls == [1, 0, 0]


def test_decide_pipeline_fast_then_low_bubble():
    cands = [
        {"schedule": "gpipe", "microbatches": 4, "step_s": 1.00,
         "bubble_fraction": 0.43, "in_flight": 4},
        {"schedule": "1f1b", "microbatches": 4, "step_s": 1.01,
         "bubble_fraction": 0.43, "in_flight": 2},
        {"schedule": "1f1b", "microbatches": 8, "step_s": 1.02,
         "bubble_fraction": 0.27, "in_flight": 2},
        {"schedule": "gpipe", "microbatches": 8, "step_s": 0.5,
         "rejected": "peak_hbm"},
        {"schedule": "interleaved", "microbatches": 8, "step_s": 2.0,
         "bubble_fraction": 0.1, "in_flight": 4}]
    d = autotune.decide_pipeline(cands, tol=0.03)
    assert d["chosen"] == {"schedule": "1f1b", "microbatches": 8}
    assert d == jax_at.decide_pipeline(cands, tol=0.03)
    with pytest.raises(ValueError):
        autotune.decide_pipeline([{"schedule": "gpipe", "microbatches": 2,
                                   "rejected": "x"}])


def _staged_fc(pkg, stages, microbatches=2, size=8):
    x = pkg.layers.data("x", shape=[size])
    pipe = pkg.layers.Pipeline(microbatches=microbatches)
    for i in range(stages):
        with pipe.stage():
            c = pipe.carry(x if i == 0 else None)
            c = pkg.layers.fc(c, size=size, act="tanh")
            pipe.emit(c)
    loss = pkg.layers.mean(pkg.layers.square(pipe()))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_tune_pipeline_waits_for_a7():
    """``tune_pipeline`` (a refusal until the pipeline axis was ported):
    an explicit schedule is the user's pin, recorded and never measured,
    as the JAX tuner records it; a program with no region, or whose
    regions no schedule runs pipelined on the mesh, is refused before any
    candidate runs (the measured path: ``test_torch_program_sp_pp.py``,
    in a world of two)."""
    feed = {"x": np.zeros((8, 8), "float32")}
    mesh = pt.make_mesh((1, 2), ("dp", "pp"))
    decisions = []
    for pkg, tuner, mk in ((pt, autotune, lambda: mesh),
                           (fluid, jax_at, None)):
        if mk is None:
            from paddle_tpu.parallel import make_mesh

            mk = lambda: make_mesh((1, 2), ("dp", "pp"))  # noqa: E731
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss = _staged_fc(pkg, 2)
        bs = pkg.BuildStrategy()
        bs.pipeline_schedule = "1f1b"
        bs.pipeline_microbatches = 4
        cfg = tuner.TunedConfig()
        d = tuner.tune_pipeline(main, startup, feed, loss, mk(),
                                build_strategy=bs, config=cfg)
        assert cfg.get("pipeline")["source"] == "pinned"
        decisions.append(d)
    assert decisions[0] == decisions[1]
    assert decisions[0]["evidence"] == "pinned"
    assert decisions[0]["chosen"] == {"schedule": "1f1b", "microbatches": 4}
    assert decisions[0]["candidates"] == []
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", shape=[8])
        plain = pt.layers.mean(pt.layers.fc(x, size=4))
    with pytest.raises(ValueError, match="no pipeline_region"):
        autotune.tune_pipeline(main, startup, feed, plain, mesh)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = _staged_fc(pt, 3)
    # three stages fit neither pp = 2 (gpipe, 1f1b) nor a multiple of it
    with pytest.raises(ValueError, match="no schedule runs"):
        autotune.tune_pipeline(main, startup, feed, loss, mesh)


# ---------------------------------------------------------------------------
# quantization: the accuracy gate and the quant-kernel table
# ---------------------------------------------------------------------------

def _fc_program(seed=7, d_in=64, d_h=128, d_out=16):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[d_in])
        h = pt.layers.fc(x, size=d_h, act="relu")
        pred = pt.layers.fc(h, size=d_out, act="softmax")
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    return main, pred, scope, exe


def test_tune_quantization_picks_mode_and_records_evidence():
    main, pred, scope, _ = _fc_program()
    feed = {"x": np.random.RandomState(0).rand(16, 64).astype("float32")}
    cfg = autotune.TunedConfig(meta={"model": "test"})
    d = autotune.tune_quantization(main, scope, feed, [pred], CPU,
                                   probe_steps=2, min_speedup=0.0,
                                   config=cfg)
    assert d["chosen"] in ("weight_only", "dynamic")
    assert d["accuracy_delta"] <= d["accuracy_budget"]
    assert {c["mode"] for c in d["candidates"]} == {"weight_only",
                                                    "dynamic"}
    for c in d["candidates"]:
        assert "accuracy_delta" in c and "step_s" in c
    got = cfg.get("quantization")
    assert got is not None and got["chosen"] == d["chosen"]
    assert got["evidence"] == "measured_ab_window+eval_delta"


def test_tune_quantization_rejects_corrupted_scales_keeps_fp():
    from paddle_tpu_torch.transpiler.quantize_pass import (
        SCALE_SUFFIX, quantize_inference)

    main, pred, scope, _ = _fc_program()
    feed = {"x": np.random.RandomState(0).rand(16, 64).astype("float32")}
    cfg = autotune.TunedConfig(meta={"model": "test"})
    qbad = quantize_inference(main, scope=scope, mode="weight_only")
    sname = "fc_0.w_0" + SCALE_SUFFIX
    scope.set_var(sname, scope.find_var(sname) * 100.0)
    d = autotune.tune_quantization(main, scope, feed, [pred], CPU,
                                   probe_steps=2, min_speedup=0.0,
                                   candidates=[("weight_only", qbad)],
                                   config=cfg)
    assert d["chosen"] is None
    (cand,) = d["candidates"]
    assert cand["status"] == "rejected_accuracy"
    assert cand["accuracy_delta"] > d["accuracy_budget"]
    assert cfg.get("quantization")["candidates"][0]["status"] == \
        "rejected_accuracy"


def test_tune_quantization_pinned_mode_wins():
    main, pred, scope, _ = _fc_program()
    feed = {"x": np.random.RandomState(0).rand(4, 64).astype("float32")}
    flags.set_flags({"FLAGS_quantize_mode": "off"})
    cfg = autotune.TunedConfig(meta={})
    d = autotune.tune_quantization(main, scope, feed, [pred], CPU,
                                   config=cfg)
    assert d["chosen"] is None and d["evidence"] == "pinned"
    assert cfg.get("quantization")["source"] == "pinned"
    flags.set_flags({"FLAGS_quantize_mode": "dynamic"})
    assert autotune.tune_quantization(main, scope, feed, [pred],
                                      CPU)["chosen"] == "dynamic"


def test_decide_quantization_pure_policy():
    cands = [
        {"mode": "weight_only", "accuracy_delta": 0.001, "step_s": 0.5},
        {"mode": "dynamic", "accuracy_delta": 0.5, "step_s": 0.2},
        {"mode": "broken", "rejected": "error: boom"},
    ]
    d = autotune.decide_quantization(1.0, cands, budget=0.02,
                                     min_speedup=1.0, batch=10)
    assert d["chosen"] == "weight_only"
    by_mode = {c["mode"]: c for c in d["candidates"]}
    assert by_mode["dynamic"]["status"] == "rejected_accuracy"
    assert by_mode["weight_only"]["status"] == "ok"
    assert "status" not in by_mode["broken"]
    assert d["chosen_tok_s"] == 20.0 and d["fp_tok_s"] == 10.0
    d2 = autotune.decide_quantization(
        1.0, [{"mode": "weight_only", "accuracy_delta": 0.001,
               "step_s": 1.5}], budget=0.02)
    assert d2["chosen"] is None
    assert d2["candidates"][0]["status"] == "rejected_slower"


def test_quant_kernel_table_and_choice(tmp_path):
    table = autotune.AttentionDecisionTable(
        dirname=str(tmp_path), filename=autotune.QUANT_FILENAME)
    tok0 = autotune.trace_token()
    d = autotune.tune_quant_kernel(8, 128, 128, "float32", CPU,
                                   mode="dynamic", table=table,
                                   probe_steps=2)
    assert d["knob"] == "quant_kernel" and d["xla_step_s"] > 0
    key = autotune.quant_shape_key(8, 128, 128, "float32", "dynamic")
    assert table.lookup("", key) is not None
    assert os.path.exists(str(tmp_path / autotune.QUANT_FILENAME))
    d2 = autotune.tune_quant_kernel(8, 128, 128, "float32", CPU,
                                    mode="dynamic", table=table)
    assert d2.get("cached") is True and d2["pallas"] == d["pallas"]
    autotune.quant_kernel_table().record("", key, False)
    assert autotune.quant_kernel_choice(8, 128, 128, torch.float32,
                                        "dynamic") is False
    assert autotune.trace_token() != tok0
    # weight_only has no library arm: the kernel, nothing measured
    wo = autotune.tune_quant_kernel(8, 128, 128, "float32", CPU,
                                    table=table)
    assert wo["pallas"] is True and wo["evidence"] == "no_library_arm"
    # nor a dynamic shape torch._int_mm cannot take (N not a multiple of 8)
    odd = autotune.tune_quant_kernel(8, 128, 100, "float32", CPU,
                                     mode="dynamic", table=table)
    assert odd["evidence"] == "no_library_arm"


def test_tuned_config_applies_quant_kernel_rulings():
    key = autotune.quant_shape_key(16, 256, 256, "bfloat16")
    cfg = autotune.TunedConfig(decisions=[
        {"knob": "quant_kernel", "shape": key, "pallas": True},
        {"knob": "quantization", "chosen": "weight_only"}])
    outcomes = dict(cfg.apply())
    assert outcomes["quant_kernel"] == "applied"
    assert outcomes["quantization"] == "advisory"
    assert autotune.quant_kernel_choice(16, 256, 256,
                                        torch.bfloat16) is True


def test_library_arms_on_the_cpu_match_the_plain_versions():
    """The library arms' arithmetic (they run on the card only through a
    ruling): SDPA with the kernel's masks equals the plain attention,
    fully masked rows zero; the ``torch._int_mm`` arm's int32 product
    equals the plain version's."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    g = torch.Generator().manual_seed(0)
    for tq, tk in ((16, 16), (1, 40), (4, 40)):
        q = torch.randn(2, 2, tq, 64, generator=g)
        k = torch.randn(2, 2, tk, 64, generator=g)
        v = torch.randn(2, 2, tk, 64, generator=g)
        klen = torch.tensor([tk, 0 if tq == tk else tq], dtype=torch.int32)
        got = fa.library_attention(q, k, v, klen, True)
        want = fa.reference_attention(q, k, v, klen, None, True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert qm.has_library_arm(512, 32000, "dynamic")
    assert not qm.has_library_arm(512, 32000, "weight_only")
    assert not qm.has_library_arm(500, 32000, "dynamic")
    x = torch.randn(8, 64, generator=g)
    qw = torch.randint(-127, 128, (64, 40), dtype=torch.int8, generator=g)
    sc = torch.rand(40, generator=g) / 100
    if hasattr(torch, "_int_mm"):
        try:
            got = qm.library_dequant_matmul(x, qw, sc)
        except RuntimeError:     # the CPU build lacks the int8 GEMM
            got = None
        if got is not None:
            torch.testing.assert_close(
                got, qm.dequant_matmul_reference(x, qw, sc, "dynamic"),
                rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# serving wiring
# ---------------------------------------------------------------------------

@pytest.fixture
def saved_fc(tmp_path):
    main, pred, scope, exe = _fc_program(d_in=32, d_h=64, d_out=8)
    d = str(tmp_path / "model")
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ["x"], [pred], exe, main_program=main)
    feed = {"x": np.random.RandomState(0).rand(4, 32).astype("float32")}
    (ref,) = exe.run(main, feed=feed, fetch_list=[pred], scope=scope)
    return d, feed, ref


def test_inference_engine_quantized_matches_fp(saved_fc):
    from paddle_tpu_torch.serving import InferenceEngine

    d, feed, ref = saved_fc
    eng = InferenceEngine(model_dir=d, slots=4, timeout_s=60.0, place=CPU,
                          quantize="weight_only")
    try:
        assert eng.quantize_mode == "weight_only"
        assert "dequant_matmul" in [
            op.type for op in eng._program.global_block().ops]
        outs = np.stack([np.asarray(eng.run({"x": feed["x"][i]})[0])
                         for i in range(4)])
        assert autotune.eval_delta([ref], [outs]) < 0.02
    finally:
        eng.close()


def test_inference_engine_consumes_tuned_config(saved_fc, tmp_path):
    from paddle_tpu_torch.serving import InferenceEngine

    d, feed, ref = saved_fc
    cfg = autotune.TunedConfig(decisions=[
        {"knob": "quantization", "chosen": "weight_only"},
        {"knob": "batch_size", "chosen": 3}])
    path = cfg.save(str(tmp_path / "tuned.json"))
    eng = InferenceEngine(model_dir=d, timeout_s=60.0, place=CPU,
                          tuned_config=path)
    try:
        assert eng.quantize_mode == "weight_only" and eng.slots == 3
        out = np.asarray(eng.run({"x": feed["x"][0]})[0])
        assert autotune.eval_delta([ref[:1]], [out[None]]) < 0.02
    finally:
        eng.close()
    # a gate that kept full precision does not quantize; an explicit
    # quantize= beats the ruling
    eng2 = InferenceEngine(model_dir=d, slots=4, timeout_s=60.0, place=CPU,
                           tuned_config=autotune.TunedConfig(decisions=[
                               {"knob": "quantization", "chosen": None}]))
    eng3 = InferenceEngine(model_dir=d, slots=4, timeout_s=60.0, place=CPU,
                           tuned_config=cfg, quantize="dynamic")
    try:
        assert eng2.quantize_mode is None
        assert eng3.quantize_mode == "dynamic"
    finally:
        eng2.close()
        eng3.close()


def test_enable_serving_tuned_config_reaches_the_engine(saved_fc, tmp_path):
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    d, feed, ref = saved_fc
    path = autotune.TunedConfig(decisions=[
        {"knob": "quantization", "chosen": "dynamic"}]).save(
        str(tmp_path / "tuned.json"))
    cfg = AnalysisConfig(model_dir=d, use_gpu=False)
    cfg.place = CPU
    cfg.enable_serving(slots=2, timeout_s=60.0, tuned_config=path)
    pred = create_paddle_predictor(cfg)
    try:
        eng = pred.serving_engine()
        assert eng.quantize_mode == "dynamic"
        out = pred.run({"x": feed["x"][:1]})
        assert autotune.eval_delta([ref[:1]], [out[0].data]) < 0.02
    finally:
        pred.serving_engine().close()


def _lm(**kw):
    from paddle_tpu_torch.serving import build_decoder_lm

    return build_decoder_lm(vocab_size=23, max_len=32, slots=2, n_layer=1,
                            n_head=1, d_model=64, d_inner=32, **kw)


def test_generation_engine_consumes_tuned_config(tmp_path):
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = autotune.TunedConfig(decisions=[
        {"knob": "quantization", "chosen": "weight_only"},
        autotune.choose_bucket_bounds([3, 4, 5, 9], k=2, multiple=8,
                                      max_len=16)])
    path = cfg.save(str(tmp_path / "tuned.json"))
    spec = _lm()
    ref = GenerationEngine(spec, place=CPU, max_new_tokens=3)
    eng = GenerationEngine(spec, place=CPU, max_new_tokens=3,
                           tuned_config=path)
    try:
        assert eng.quantize_mode == "weight_only"
        assert eng._sched.bucket_bounds == [8, 16]
        assert "dequant_matmul" in [op.type for op in
                                    eng.spec.decode_program.global_block()
                                    .ops]
        assert len(eng.generate([3, 5, 7])) == len(ref.generate([3, 5, 7]))
    finally:
        eng.close()
        ref.close()


def test_tune_kv_quantization_rides_the_accuracy_gate():
    prompts = [[3, 5, 7], [2, 9, 4, 6]]

    def build(kv_dtype):
        return _lm(paged=True, page_size=8, kv_dtype=kv_dtype,
                   prefix="kvg")

    cfg = autotune.TunedConfig()
    d = autotune.tune_kv_quantization(build, prompts, place=CPU,
                                      max_new_tokens=3, config=cfg)
    assert d["knob"] == "kv_quantization"
    assert d["chosen"] == "kv_int8"
    cand = d["candidates"][0]
    assert cand["accuracy_delta"] < d["accuracy_budget"]
    assert cand["greedy_tokens_match"] is True
    assert cfg.get("kv_quantization") is not None
    d2 = autotune.tune_kv_quantization(build, prompts, place=CPU,
                                       max_new_tokens=3, budget=1e-12)
    assert d2["chosen"] is None
    assert d2["candidates"][0]["status"] == "rejected_accuracy"


def test_tune_speculation_k_keeps_greedy_outputs():
    from paddle_tpu_torch.serving import GenerationEngine

    prompts = [[3, 5, 7], [2, 9, 4]]

    def make_engine(k):
        spec = _lm(spec_k=k) if k else _lm()
        if not k:
            return GenerationEngine(spec, place=CPU, max_new_tokens=4)
        from paddle_tpu_torch.serving import sync_draft_weights

        draft = _lm(prefix="draft")
        eng = GenerationEngine(spec, place=CPU, max_new_tokens=4,
                               draft_spec=draft, start=False)
        sync_draft_weights(eng._scope, spec, draft)
        eng.start()
        return eng

    d = autotune.tune_speculation_k(make_engine, prompts,
                                    candidates=(None, 2))
    assert d["knob"] == "speculation_k"
    by_k = {c["k"]: c for c in d["candidates"]}
    assert by_k[None]["tok_s"] > 0 and not by_k[2].get("rejected")
    assert by_k[2]["acceptance_rate"] is not None
    assert d["chosen"] in (None, 2)


# ---------------------------------------------------------------------------
# the two packages
# ---------------------------------------------------------------------------

def _draw_lengths(rng):
    n = rng.randint(1, 40)
    return [int(x) for x in rng.randint(1, rng.randint(2, 200), n)]


def _pure_cases():
    """(name, draw(rng) -> (args, kwargs)) of every pure decision."""
    def ladder(rng):
        return ((int(rng.randint(1, 64)), int(rng.randint(1, 5000)),
                 float(rng.choice([1.5, 2, 3]))), {})

    def projection(rng):
        pairs = [(int(b), int(rng.randint(1, 1e9)) if rng.rand() > 0.1
                  else 0) for b in rng.randint(1, 512, rng.randint(0, 6))]
        return (pairs, int(rng.randint(1, 4096))), {}

    def run_ladder(rng):
        rungs = autotune.batch_ladder(int(rng.randint(1, 32)), 2048)
        slope, base = rng.rand() * 1e6, rng.rand() * 1e7
        spe = {b: rng.rand() + 0.1 for b in rungs}
        limit = None if rng.rand() < 0.2 else float(rng.rand() * 3e9)
        return ((rungs, limit, lambda b: base + slope * b
                 if rng.rand() > 0.05 else None,
                 lambda b: spe[b] * b),
                {"regress_tol": float(rng.rand() * 0.2),
                 "headroom": float(0.5 + rng.rand() * 0.5)})

    def ab(rng):
        return ((float(rng.rand()), float(rng.rand() * (rng.rand() > .05))),
                {"min_speedup": float(1 + rng.rand() * 0.2)})

    def fill(rng):
        lengths = _draw_lengths(rng)
        bounds = sorted(set(int(b) for b in rng.randint(1, 220, 4)))
        return (lengths, bounds), {}

    def bounds(rng):
        lengths = _draw_lengths(rng)
        return (lengths,), {"k": int(rng.randint(1, 6)),
                            "multiple": int(rng.choice([1, 8, 16, 32])),
                            "max_len": None if rng.rand() < .5
                            else max(lengths) + int(rng.randint(0, 50))}

    def interval(rng):
        return ((float(rng.rand() + 1e-3), float(rng.rand()),
                 float(rng.rand() * 5)),
                {"budget": float(rng.rand() * 0.1 + 1e-3),
                 "async_save": bool(rng.rand() > 0.5),
                 "replay_step_s": None if rng.rand() < .5
                 else float(rng.rand())})

    def pipeline(rng):
        cands = [{"schedule": str(rng.choice(["gpipe", "1f1b",
                                              "interleaved"])),
                  "microbatches": int(rng.choice([2, 4, 8])),
                  "step_s": float(rng.rand() + 0.01),
                  "bubble_fraction": float(rng.rand()),
                  "in_flight": int(rng.randint(1, 8))}
                 for _ in range(rng.randint(1, 6))]
        cands[-1].setdefault("rejected", None)
        return (cands,), {"tol": float(rng.rand() * 0.1)}

    def delta(rng):
        shape = (int(rng.randint(1, 5)), int(rng.randint(1, 7)))
        ref = [rng.randn(*shape) for _ in range(rng.randint(1, 3))]
        return (ref, [r + rng.randn(*shape) * rng.rand() for r in ref]), {}

    def quantization(rng):
        cands = []
        for mode in ("weight_only", "dynamic", "x"):
            c = {"mode": mode}
            if rng.rand() < 0.15:
                c["rejected"] = "error: x"
            else:
                c["accuracy_delta"] = float(rng.rand() * 0.05)
                c["step_s"] = float(rng.rand() + 0.01)
            cands.append(c)
        return ((float(rng.rand() + 0.01), cands, float(rng.rand() * 0.04)),
                {"min_speedup": float(rng.rand() * 1.5),
                 "batch": None if rng.rand() < .3
                 else int(rng.randint(1, 64))})

    return [("batch_ladder", ladder), ("project_peak_hbm", projection),
            ("run_batch_ladder", run_ladder),
            ("decide_attention_kernel", ab), ("decide_quant_kernel", ab),
            ("token_fill", fill), ("choose_bucket_bounds", bounds),
            ("decide_checkpoint_interval", interval),
            ("decide_pipeline", pipeline), ("eval_delta", delta),
            ("decide_quantization", quantization)]


@pytest.mark.parametrize("name,draw", _pure_cases(),
                         ids=[c[0] for c in _pure_cases()])
def test_pure_decisions_equal_jax(name, draw):
    """200 seeded draws a function: the port's output equals the JAX
    package's on the same inputs (callbacks replayed draw for draw)."""
    for seed in range(200):
        outs = []
        for mod in (autotune, jax_at):
            args, kw = draw(np.random.RandomState(seed))
            try:
                outs.append(("ok", getattr(mod, name)(*args, **kw)))
            except ValueError as e:
                outs.append(("raises", str(e)))
        assert outs[0] == outs[1], (name, seed, outs)


def _decisions():
    return [
        {"knob": "batch_size", "chosen": 256,
         "candidates": [{"batch": 256, "status": "ok", "step_s": 0.2,
                         "s_per_example": 0.0008,
                         "peak_hbm_bytes": 29 << 30},
                        {"batch": 512, "status": "rejected_projected_hbm",
                         "projected_peak_hbm_bytes": 80 << 30}],
         "hbm_limit_bytes": 80 << 30, "evidence": "x"},
        dict(autotune.decide_checkpoint_interval(0.43, 0.2, 3.5),
             fingerprint="0123456789ab"),
        dict(autotune.decide_attention_kernel(0.05, 0.04),
             shape="T256:K256:d64:float32"),
        dict(autotune.decide_attention_kernel(0.01, 0.02),
             shape="T1:K1024:d64:float32"),
        dict(autotune.decide_quant_kernel(0.05, 0.01),
             shape="M8:K512:N32000:float32:dynamic"),
        {"knob": "quant_kernel", "shape": "M8:K512:N32000:float32:"
         "weight_only", "pallas": True, "evidence": "no_library_arm"},
        autotune.decide_quantization(
            1.0, [{"mode": "dynamic", "accuracy_delta": 0.01,
                   "step_s": 0.5}], 0.02),
        autotune.choose_bucket_bounds([60, 120, 200], k=2, multiple=64)]


def _choices(mod):
    return (mod.attention_choice((8, 8, 256, 64), (8, 8, 256, 64),
                                 "float32"),
            mod.attention_choice((8, 8, 1, 64), (8, 8, 1024, 64),
                                 "float32"),
            mod.quant_kernel_choice(8, 512, 32000, "float32", "dynamic"),
            mod.quant_kernel_choice(8, 512, 32000, "float32",
                                    "weight_only"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_and_tables_cross_packages(writer, tmp_path):
    """A TunedConfig and both decision tables written by one package load
    in the other, ``apply()`` gives the same outcomes, and the rulings
    answer alike."""
    src, dst = (jax_at, autotune) if writer == "jax" else (autotune, jax_at)
    tables = str(tmp_path / "tables")
    cfg = src.TunedConfig(meta={"model": writer})
    for d in _decisions():
        cfg.add(d, fingerprint=d.get("fingerprint"))
    path = cfg.save(str(tmp_path / "tuned.json"))
    for fl in (jax_flags, flags):
        fl.set_flags({"autotune_dir": tables}, pin=False)
    src.attention_table().record("fpA", "T256:K256:d64:float32", True)
    src.attention_table().record("fpA", "T1:K1024:d64:float32", False)
    src.quant_kernel_table().record("fpQ", "M8:K512:N32000:float32:"
                                    "dynamic", False)
    src_choices = _choices(src)
    loaded = dst.TunedConfig.load(path)
    assert loaded.as_dict() == json.loads(open(path).read())
    assert loaded.value("batch_size") == 256
    assert loaded.value("checkpoint_interval") == cfg.value(
        "checkpoint_interval")
    # the other package reads the persisted tables in a fresh state
    dst.reset_attention_table()
    dst.reset_quant_kernel_table()
    assert _choices(dst) == src_choices == (True, False, False, None)
    # apply() installs the artifact's rulings and names the same outcomes
    for mod in (jax_at, autotune):
        mod.reset_attention_table()
        mod.reset_quant_kernel_table()
    for fl in (jax_flags, flags):
        fl.set_flags({"autotune_dir": ""}, pin=False)
    out_src = src.TunedConfig.load(path).apply()
    out_dst = loaded.apply()
    assert out_src == out_dst
    assert _choices(src) == _choices(dst) == (True, False, True, True)


def test_trainer_interval_and_events_equal_jax(tmp_path):
    """``Trainer(autotune=)`` takes the artifact's interval as the JAX
    Trainer does, with the same ``autotune_applied`` events."""
    from paddle_tpu.contrib import CheckpointConfig as JaxCkpt
    from paddle_tpu.contrib import Trainer as JaxTrainer
    from paddle_tpu_torch.contrib import CheckpointConfig, Trainer

    cfg = autotune.TunedConfig()
    cfg.add(autotune.decide_checkpoint_interval(0.02, 0.002, 0.01,
                                                async_save=False))
    path = cfg.save(str(tmp_path / "tuned.json"))

    def train_func(pkg):
        def f():
            x = pkg.layers.data("x", shape=[8])
            return pkg.layers.mean(pkg.layers.fc(x, size=1))
        return f

    events = {}
    got = {}
    for name, pkg, T, C, place in (
            ("jax", fluid, JaxTrainer, JaxCkpt, fluid.CPUPlace()),
            ("port", pt, Trainer, CheckpointConfig, CPU)):
        log = str(tmp_path / ("log_" + name))
        mon = fluid.monitor if name == "jax" else monitor
        mon.enable(log_dir=log)
        try:
            for interval in (None, 5):
                t = T(train_func=train_func(pkg), place=place,
                      optimizer_func=lambda pkg=pkg: pkg.optimizer.SGD(0.1),
                      checkpoint_config=C(
                          checkpoint_dir=str(tmp_path / name / str(interval)),
                          step_interval=interval),
                      autotune=path)
                got[name, interval] = t.checkpoint_cfg.step_interval
        finally:
            mon.disable()
        recs = []
        for fn in sorted(os.listdir(log)):
            if fn.endswith(".jsonl"):
                with open(os.path.join(log, fn)) as f:
                    recs += [json.loads(ln) for ln in f if ln.strip()]
        events[name] = [{k: r[k] for k in r if k not in ("ts", "run_id")}
                        for r in recs
                        if r.get("event") == "autotune_applied"]
    assert got["jax", None] == got["port", None] == cfg.value(
        "checkpoint_interval")
    assert got["jax", 5] == got["port", 5] == 5
    assert events["jax"] == events["port"] and len(events["port"]) == 4
    if fluid.monitor.enabled():
        fluid.monitor.disable()


def _report(path):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "autotune_report.py"),
         path, "--verbose"], capture_output=True, text=True, timeout=120)


def test_autotune_report_renders_both_packages_alike(tmp_path):
    docs = {}
    for name, mod in (("jax", jax_at), ("port", autotune)):
        cfg = mod.TunedConfig(meta={"model": "m", "run_id": "r",
                                    "created_ts": 1.0})
        for d in _decisions():
            cfg.add(d, fingerprint=d.get("fingerprint"))
        path = cfg.save(str(tmp_path / (name + ".json")))
        docs[name] = _report(path)
        assert docs[name].returncode == 0, docs[name].stderr
    assert docs["jax"].stdout == docs["port"].stdout
    for knob in ("batch_size", "checkpoint_interval", "attention_kernel",
                 "quant_kernel", "quantization", "bucket_bounds"):
        assert knob in docs["port"].stdout


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                          reason="needs a CUDA device")


def _wide_mlp(width=4096):
    """An MLP whose activations set its peak memory: each new executor's
    side stream gets its own cuBLAS workspace, which stays allocated, so a
    rung's peak carries tens of MB from the rungs before it."""
    x = pt.layers.data("x", shape=[width])
    h = pt.layers.fc(pt.layers.fc(x, size=width, act="relu"), size=width,
                     act="relu")
    loss = pt.layers.mean(pt.layers.fc(h, size=10))
    pt.optimizer.Adam(1e-3).minimize(loss)
    rng = np.random.RandomState(0)
    return loss, lambda b: {"x": rng.rand(b, width).astype("float32")}


@pytest.mark.cuda
@cuda
def test_ladder_under_a_fake_limit_on_the_card():
    """On the card the rungs' peaks are measured: a fake
    ``FLAGS_autotune_hbm_bytes`` whose ceiling lies between the 8192
    rung's peak and the 16384 rung's stops the ladder by projection at
    16384, with no warm-up over the limit; one capture a measured rung."""
    loss, make_feed = _wide_mlp()
    args = (pt.default_main_program(), pt.default_startup_program(),
            make_feed, loss, pt.CUDAPlace(0))
    ladder = [4096, 8192, 16384]
    d = autotune.tune_batch_size(*args, ladder=ladder, probe_steps=2,
                                 regress_tol=1e9)
    peaks = [c["peak_hbm_bytes"] for c in d["candidates"]]
    assert len(peaks) == 3 and all(peaks), d
    assert all(c["captures"] == 1 for c in d["candidates"]), d
    limit = int((peaks[1] + peaks[2]) / 2 / 0.9)
    flags.set_flags({"autotune_hbm_bytes": limit}, pin=False)
    d2 = autotune.tune_batch_size(*args, ladder=ladder, probe_steps=2,
                                  regress_tol=1e9)
    assert d2["hbm_limit_bytes"] == limit
    last = d2["candidates"][-1]
    assert last["batch"] == 16384 and \
        last["status"] == "rejected_projected_hbm", (d, d2)
    assert all((c.get("peak_hbm_bytes") or 0) <= limit
               for c in d2["candidates"]), (d, d2)


@pytest.mark.cuda
@cuda
def test_changed_ruling_recaptures_once_on_the_card():
    """A ruling installed between runs sends the next run to a new entry,
    which captures once; under ``false`` no kernel #1 launches, and the
    outputs agree with the kernel's."""
    from paddle_tpu_torch.ops import cuda as kernels

    loss, feed, shape = _attention_program()
    main = pt.default_main_program()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(pt.default_startup_program())
    key = autotune.attention_shape_key(*shape)
    outs = {}
    for ruling in (True, False):
        autotune.attention_table().record("", key, ruling, persist=False)
        before = sum(st.graphs for st in exe._steps.values())
        kernels.reset_launch_counts()
        for _ in range(3):
            (outs[ruling],) = exe.run(main, feed=feed, fetch_list=[loss])
        assert sum(st.graphs for st in exe._steps.values()) - before == 1
        assert (kernels.launch_counts()["flash_attention_fwd"] > 0) \
            == ruling
    np.testing.assert_allclose(outs[False], outs[True], rtol=2e-4,
                               atol=2e-4)
